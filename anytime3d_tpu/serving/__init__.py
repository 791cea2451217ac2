"""Serving layer: AOT StableHLO export + fixed-shape micro-batching.

Replaces the reference's eager per-image test-script inference
(``/root/reference/test_modelnet_3D.py``, ``nolbo_test.py``) with a
deployable artifact (``export_infer``/``load_infer``) and a fixed-shape
request coalescer (``MicroBatcher``)."""

from anytime3d_tpu.serving.batcher import MicroBatcher
from anytime3d_tpu.serving.export import (
    export_detector,
    export_infer,
    load_infer,
    make_infer_fn,
)

__all__ = ["MicroBatcher", "export_detector", "export_infer", "load_infer", "make_infer_fn"]
