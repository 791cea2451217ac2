"""Training CLI — one entry point for every experiment in the variant table.

Replaces the 17 copy-pasted train_*.py reference scripts with
``python -m anytime3d_tpu.cli.train --config modelnet_nolbo --data <path>``.
``--data synthetic`` runs on procedural voxels (smoke tests / benches).
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np


def build_batch_fn(loader, model_cfg, batch_size=32, image_size=None, multi_scale=None,
                   packed=False):
    """Adapt a reference-style loader dict/tuple to the train-step batch dict.

    Handles all three loader contracts: modelnet dict batches
    (modelnet_dataset.py:86-91), pascal 6-tuples (pascal3D.py:277-283), and
    kitti 5-tuples (train_kitti.py:94-100). ``multi_scale`` is a list of
    (rows, cols, batch) walked on the reference's shuffled 3-iteration
    cadence (train_pascal.py:121-124); each size bucket compiles once."""
    from anytime3d_tpu.train.trainer import multi_scale_schedule

    def batch_fn(_it: int):
        size, bs = image_size, batch_size
        if multi_scale:
            rows, cols, bs = multi_scale_schedule(multi_scale, _it)
            size = (cols, rows)
        if size is not None:
            b = loader.getNextBatch(bs, imageSize=size)
        else:
            b = loader.getNextBatch(bs)
        if isinstance(b, dict):  # modelnet-style
            if packed:
                from anytime3d_tpu.data.packing import pack_voxels, pack_voxels_blocked
                from anytime3d_tpu.models.mmvae import blocked_io_block

                block = blocked_io_block(model_cfg)
                if block is not None:
                    # bits pre-ordered in the coarse layout: the device-side
                    # unpack lands directly where the blocked encoder reads
                    out = {
                        "input_packed_blocked": jnp.asarray(
                            pack_voxels_blocked(b["input_images"], block)
                        )
                    }
                else:
                    out = {"input_packed": jnp.asarray(pack_voxels(b["input_images"]))}
            else:
                out = {
                    "input": jnp.asarray(b["input_images"]),
                    "target": jnp.asarray(b["input_images"]),
                }
            if model_cfg.prior_category is not None or model_cfg.category_dim:
                out["category_onehot"] = jnp.asarray(b["class_list"])
            if model_cfg.inst_dim:
                out["inst_onehot"] = jnp.asarray(b["inst_list"])
            return out
        if len(b) == 5:  # kitti-style (inst, sin, cos, images, voxels)
            inst, _sin, _cos, images, voxels = b
            cls = None
        else:  # pascal-style (inst, cls, sin, cos, images, voxels)
            inst, cls, _sin, _cos, images, voxels = b
        out = {"input": jnp.asarray(images)}
        if packed:
            # image->shape: the 64^3 target still rides the 32x bit transfer;
            # blocked bit order when the decoder tail is blocked, so the loss
            # runs in the coarse layout with zero device relayout
            from anytime3d_tpu.data.packing import pack_voxels, pack_voxels_blocked
            from anytime3d_tpu.models.mmvae import decoder_blocked_block

            dblock = decoder_blocked_block(model_cfg)
            if dblock is not None:
                out["target_packed_blocked"] = jnp.asarray(
                    pack_voxels_blocked(np.asarray(voxels), dblock)
                )
            else:
                out["target_packed"] = jnp.asarray(pack_voxels(np.asarray(voxels)))
        else:
            out["target"] = jnp.asarray(voxels)
        if cls is not None and (model_cfg.prior_category is not None or model_cfg.category_dim):
            out["category_onehot"] = jnp.asarray(cls)
        if model_cfg.inst_dim:
            out["inst_onehot"] = jnp.asarray(inst)
        return out

    return batch_fn


def build_loaders(args, model_cfg):
    """Construct (train, eval) loaders for any config family from CLI args.

    Dataset selection mirrors the reference entry scripts: ModelNet shards
    for voxel configs, Pascal3D per-object crops for image configs
    (train_pascal.py:82-85), KITTI crops + CAD set for kitti configs
    (train_kitti.py:52); ``--data synthetic`` substitutes procedural shapes
    (and their rendered projections for image configs)."""
    from anytime3d_tpu.data import (
        KittiSingleObjectLoader,
        ModelNetLoader,
        Pascal3DSingleObjectLoader,
        SyntheticImageObjectLoader,
        SyntheticVoxelLoader,
    )

    image_encoder = model_cfg.encoder == "image"
    n_cls = model_cfg.category_dim if model_cfg.category_dim else 40
    n_inst = model_cfg.inst_dim if model_cfg.inst_dim else 10

    if args.data == "synthetic":
        mk = SyntheticImageObjectLoader if image_encoder else SyntheticVoxelLoader
        dim = model_cfg.decoder.output_shape[0]
        return (
            mk(num_samples=1024, dim=dim, num_classes=n_cls, num_inst=n_inst),
            mk(num_samples=256, dim=dim, num_classes=n_cls, num_inst=n_inst, seed=1),
        )
    if "kitti" in args.config:
        cad = getattr(args, "cad_path", None)
        if cad is None:
            raise SystemExit("KITTI configs need --cad-path (64^3 CAD .npy dir)")
        return (
            KittiSingleObjectLoader(args.data, cad, "train"),
            KittiSingleObjectLoader(args.data, cad, "val"),
        )
    if image_encoder:
        return (
            Pascal3DSingleObjectLoader(args.data, "train"),
            Pascal3DSingleObjectLoader(args.data, "val"),
        )
    # partial_num=None: read every shard present (full dataset = the
    # reference's 30; subsets/fixtures get what exists)
    return (
        ModelNetLoader(args.data, "train", partial_num=None),
        ModelNetLoader(args.data, "test", partial_num=None),
    )


def main(argv=None):
    """Train one registry config; returns the final TrainState."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True, help="name from models.configs.REGISTRY")
    parser.add_argument("--data", default="synthetic", help="dataset path or 'synthetic'")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--steps", type=int, default=1000)
    parser.add_argument("--learning-rate", type=float, default=1e-4)
    parser.add_argument("--save-path", default=None)
    parser.add_argument("--load-path", default=None)
    parser.add_argument("--jsonl", default=None)
    parser.add_argument("--eval-every", type=int, default=200)
    parser.add_argument("--save-every", type=int, default=1000)
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute dtype")
    parser.add_argument("--mesh", action="store_true", help="shard batch over all devices")
    parser.add_argument("--image-size", type=int, default=64,
                        help="square image size for image-encoder configs")
    parser.add_argument("--packed", action="store_true",
                        help="bit-pack voxel batches host->device (32x less transfer)")
    parser.add_argument("--multi-scale", default=None,
                        help="comma list of square sizes, e.g. '48,64,80' — "
                             "multi-scale schedule for image configs")
    parser.add_argument("--cad-path", default=None,
                        help="CAD voxel dir (KITTI configs; Pascal uses --data's CAD/)")
    parser.add_argument("--swap-splits", action="store_true",
                        help="train on the eval split and eval on train — the "
                             "reference's train_pascal{,_AE,_VAE}_test.py variants "
                             "(train_pascal_test.py:129-130)")
    args = parser.parse_args(argv)

    from anytime3d_tpu.models import configs
    from anytime3d_tpu.models.mmvae import MultiModalVAE
    from anytime3d_tpu.train import create_train_state
    from anytime3d_tpu.train.trainer import Trainer, TrainerConfig
    from anytime3d_tpu.utils.profiling import enable_compilation_cache

    enable_compilation_cache()

    model_cfg, loss_cfg = configs.variant(args.config)
    dtype = jnp.bfloat16 if args.bf16 else jnp.float32
    model = MultiModalVAE(model_cfg, dtype=dtype)

    image_encoder = model_cfg.encoder == "image"
    image_size = (args.image_size, args.image_size) if image_encoder else None
    loader, eval_loader = build_loaders(args, model_cfg)
    if args.swap_splits:
        loader, eval_loader = eval_loader, loader

    # datasets define the class count (the reference sizes its one-hots from
    # the CAD dir walk, pascal3D.py:21-54): when a real dataset disagrees
    # with the variant's default (e.g. a Pascal subset), rebuild the config
    # at the dataset's width so priornet/one-hot shapes line up.
    n_data_cls = len(getattr(loader, "class_index", ()) or ())
    if n_data_cls and model_cfg.category_dim and n_data_cls != model_cfg.category_dim:
        print(f"dataset defines {n_data_cls} classes "
              f"(config default {model_cfg.category_dim}) — resizing")
        model_cfg, loss_cfg = configs.variant(args.config, category_dim=n_data_cls)
        model = MultiModalVAE(model_cfg, dtype=dtype)

    schedule = None
    if args.multi_scale and image_encoder:
        schedule = [(int(s), int(s), args.batch_size) for s in args.multi_scale.split(",")]

    def make_loader_fn(ld, sched=None):
        return build_batch_fn(
            ld, model_cfg, args.batch_size, image_size, sched,
            packed=args.packed and not image_encoder,
        )

    init_shape = (
        (args.batch_size, args.image_size, args.image_size, 3)
        if image_encoder
        else (args.batch_size, *model_cfg.decoder.output_shape)
    )
    state = create_train_state(
        model,
        jnp.zeros(init_shape, dtype),
        jax.random.PRNGKey(0),
        learning_rate=args.learning_rate,
    )

    trainer = Trainer(
        model,
        state,
        make_loader_fn(loader, schedule),
        loss_config=loss_cfg,
        eval_batch_fn=make_loader_fn(eval_loader),
        config=TrainerConfig(
            total_steps=args.steps,
            eval_every=args.eval_every,
            save_every=args.save_every,
            save_path=args.save_path,
            load_path=args.load_path,
            jsonl_path=args.jsonl,
            use_mesh=args.mesh,
        ),
    )
    state = trainer.run(epoch_fn=lambda: loader.epoch)
    print("\ndone; final metrics:", {k: round(v, 4) for k, v in trainer.logger.means().items()})
    return state


if __name__ == "__main__":
    main()
