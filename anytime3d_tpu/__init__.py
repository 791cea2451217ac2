"""anytime3d_tpu — anytime 3D reconstruction framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
``bogus2000/anytime-3D-reconstruction`` (NOLBO, "Not Only Look, But Observe":
anytime 3D object reconstruction with a multi-modal VAE; IEEE RA-L 2022).

Layering (bottom-up, see SURVEY.md §7):

- ``ops``        pure functional math: sampling, KL, focal-BCE, prior
                 repulsion, voxel P/R, NMS, orientation k-means
- ``nn``         modules on the in-repo layer ``nn.module``: Darknet
                 backbones, 2D heads, 3D conv encoder/decoder, prior
                 networks (GroupNorm, not BatchNorm)
- ``models``     one configurable MultiModalVAE covering all reference model
                 variants, the multi-object DetectorReconstructor, Classifier
- ``train``      jitted train steps over a device mesh, trainer loop, NumPy
                 checkpointing with per-submodule composability
- ``parallel``   mesh construction and sharding rules
- ``data``       sharded host loaders (ModelNet/Pascal3D+/KITTI/ImageNet),
                 pure-numpy augmentation, voxel utilities
- ``anytime``    the anytime engine: masked-latent eval, prior correction,
                 recursive Gaussian latent fusion
- ``geometry``   camera projection, ray rotation, SVD translation recovery,
                 metric lifting (all vectorized)
- ``evaluation`` metric protocols: missing-rate sweeps, PR curves
"""

__version__ = "0.1.0"
