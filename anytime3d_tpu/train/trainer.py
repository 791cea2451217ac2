"""Training loop: prefetched batches, mesh sharding, periodic eval/save,
NaN abort, multi-scale schedule.

Reference semantics: the common loop of every train_*.py (SURVEY.md §2.6):
running-mean stdout dashboard, NaN self-abort (train_pascal.py:167-170),
epoch-boundary save (:136-143), multi-scale image/batch schedule shuffled
every 3 iterations (:121-124). Here batches prefetch to device on a
background thread; each (shape, batch) bucket compiles once and is cached;
eval runs on a cadence instead of every step (the reference evaluates train
AND test every iteration — pure overhead).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import numpy as np

from anytime3d_tpu.anytime import anytime_eval_jit
from anytime3d_tpu.parallel import batch_sharding, make_mesh, replicated, shard_batch
from anytime3d_tpu.train.checkpoint import restore_state, save_state
from anytime3d_tpu.train.state import TrainState
from anytime3d_tpu.train.step import LossConfig, make_eval_step, make_train_step
from anytime3d_tpu.utils.logging import MetricLogger


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 1000
    eval_every: int = 100
    save_every: int = 1000
    log_every: int = 1
    save_path: Optional[str] = None
    load_path: Optional[str] = None
    jsonl_path: Optional[str] = None
    # NOTE: the multi-scale image schedule is a LOADER concern — it changes
    # the batch the loader assembles — so it lives in the batch_fn
    # (cli/train.py::build_batch_fn + multi_scale_schedule below), not here.
    use_mesh: bool = False
    eval_missing_prob: float = 0.5
    # background device prefetch: batches are assembled on a worker thread
    # and moved to device `prefetch_depth` steps ahead, overlapping host
    # work (cv2 decode/augment — the reference's throughput wall,
    # train_pascal.py:129-134) with device compute. 0 = synchronous.
    prefetch_depth: int = 2
    # failure recovery: on NaN/Inf loss, restore the last checkpoint and
    # continue with a reseeded RNG instead of aborting (the reference can
    # only abort, train_pascal.py:167-170). 0 = abort immediately.
    max_nan_restarts: int = 0


class Trainer:
    """Drives ``make_train_step`` over a host loader.

    ``batch_fn(step) -> device-ready batch dict`` decouples the trainer from
    loader specifics; adapters for the reference loaders live in
    ``anytime3d_tpu.cli.train``.
    """

    def __init__(
        self,
        model,
        state: TrainState,
        batch_fn: Callable[[int], Dict],
        loss_config: LossConfig = LossConfig(),
        eval_batch_fn: Optional[Callable[[int], Dict]] = None,
        config: TrainerConfig = TrainerConfig(),
        step_fn: Optional[Callable] = None,
        eval_fn: Optional[Callable] = None,
    ):
        """``step_fn``/``eval_fn`` override the default MMVAE train/eval steps
        so the classifier and detector paths reuse this loop (checkpointing,
        NaN recovery, logging) with their own losses."""
        self.model = model
        self.state = state
        self.batch_fn = batch_fn
        self.eval_batch_fn = eval_batch_fn
        self.cfg = config
        self.loss_cfg = loss_config
        self._custom_step = step_fn is not None
        self._step_fn = step_fn or make_train_step(model, loss_config, donate=True)
        self._eval_fn = eval_fn or (None if step_fn else make_eval_step(model, loss_config))
        self.mesh = make_mesh() if config.use_mesh else None
        if self.mesh is not None:
            # params and optimizer state live on every device of the mesh
            self.state = jax.device_put(self.state, replicated(self.mesh))
        self.logger = MetricLogger(config.jsonl_path, print_every=config.log_every)
        self.history: List[Dict[str, float]] = []
        self.aborted_nan = False
        self._prefetcher = None
        if config.load_path:
            self.state = restore_state(config.load_path, self.state)

    def _prepare(self, batch):
        if self.mesh is not None:
            return shard_batch(batch, self.mesh)
        return batch

    def _make_prefetcher(self, start_it: int):
        """Background prefetcher pulling ``batch_fn(start_it), batch_fn(
        start_it+1), …`` on a worker thread and device-putting each batch
        ``prefetch_depth`` steps ahead of consumption."""
        from anytime3d_tpu.data.prefetch import DevicePrefetcher

        counter = iter(range(start_it, self.cfg.total_steps + self.cfg.prefetch_depth))

        def next_batch():
            return self.batch_fn(next(counter))

        # the prefetcher owns the H2D move: ONE device_put per leaf, sharded
        # over 'data' when a mesh is active (previously the mesh path
        # device_put twice — shard_batch then the prefetcher's replicate)
        sharding = batch_sharding(self.mesh) if self.mesh is not None else None
        return DevicePrefetcher(
            next_batch, sharding=sharding, depth=self.cfg.prefetch_depth
        )

    def run(self, epoch_fn: Optional[Callable[[], int]] = None) -> TrainState:
        cfg = self.cfg
        key = jax.random.PRNGKey(int(self.state.step))
        start = int(self.state.step)
        nan_restarts = 0
        last_saved_step = -1
        it = start
        self._prefetcher = self._make_prefetcher(start) if cfg.prefetch_depth > 0 else None
        try:
            return self._run_loop(epoch_fn, key, nan_restarts, last_saved_step, it)
        finally:
            if self._prefetcher is not None:
                self._prefetcher.close()
                self._prefetcher = None

    def _run_loop(self, epoch_fn, key, nan_restarts, last_saved_step, it) -> TrainState:
        cfg = self.cfg
        while it < cfg.total_steps:
            key, k_step = jax.random.split(key)
            batch = (
                self._prefetcher.get()
                if self._prefetcher is not None
                else self._prepare(self.batch_fn(it))
            )
            self.state, metrics = self._step_fn(self.state, batch, k_step)

            # fetch metrics (a device sync) only on the logging cadence —
            # per-step host syncs stall the dispatch pipeline
            do_log = it % self.cfg.log_every == 0 or it == cfg.total_steps - 1
            if do_log:
                host_metrics = {k: float(v) for k, v in metrics.items()}
                epoch = epoch_fn() if epoch_fn else 0
                self.logger.update(host_metrics, step=it, epoch=epoch)
                self.history.append(host_metrics)

                # failure detection: NaN abort (train_pascal.py:167-170) or
                # checkpoint-restore recovery when configured
                if not math.isfinite(host_metrics["loss_total"]):
                    can_restore = (
                        nan_restarts < cfg.max_nan_restarts
                        and cfg.save_path is not None
                        and last_saved_step >= 0
                    )
                    if can_restore:
                        nan_restarts += 1
                        print(
                            f"\nNaN/Inf loss at step {it} — restoring step "
                            f"{last_saved_step} checkpoint (restart {nan_restarts}/"
                            f"{cfg.max_nan_restarts})"
                        )
                        self.state = restore_state(cfg.save_path, self.state)
                        key = jax.random.PRNGKey(int(self.state.step) * 7919 + nan_restarts)
                        it = int(self.state.step)
                        if self._prefetcher is not None:
                            # rewind the batch stream to the restored step
                            self._prefetcher.close()
                            self._prefetcher = self._make_prefetcher(it)
                        continue
                    print("\nNaN/Inf loss — aborting (reference NaN-abort semantics)")
                    self.aborted_nan = True
                    break

            if cfg.save_path and (it + 1) % cfg.save_every == 0:
                # never checkpoint a non-finite state: NaN detection runs on
                # the log cadence, so an unguarded save between log ticks
                # could overwrite the last GOOD checkpoint with NaN params —
                # every NaN-restart would then reload the poison. The loss is
                # computed from the PRE-update params while the save snapshots
                # the POST-update state, so additionally require the step's
                # gradients to have been finite (metrics['grads_finite'],
                # emitted by every train step) — a finite forward with an
                # overflowed bf16 backward would otherwise checkpoint poison.
                # Two scalar syncs at save cadence (the save's own
                # device->host snapshot dwarfs them).
                if math.isfinite(float(metrics["loss_total"])) and (
                    float(metrics.get("grads_finite", 1.0)) > 0.0
                ):
                    # async: device->host snapshot now, commit in background
                    # — training overlaps the serialize (restore_state
                    # fences)
                    save_state(cfg.save_path, self.state, wait=False)
                    last_saved_step = it

            if (
                self.eval_batch_fn is not None
                and cfg.eval_every > 0
                and (it + 1) % cfg.eval_every == 0
            ):
                self.evaluate(it)
            it += 1

        if cfg.save_path and not self.aborted_nan:
            save_state(cfg.save_path, self.state)
        self.logger.close()
        return self.state

    def evaluate(self, it: int) -> Dict[str, float]:
        if self._eval_fn is None:
            return {}
        key = jax.random.PRNGKey(it)
        batch = self._prepare(self.eval_batch_fn(it))
        out = {
            f"eval_{k}": float(v)
            for k, v in self._eval_fn(self.state.params, batch, key).items()
        }
        mcfg = self.model.config
        if (
            not self._custom_step
            and mcfg.prior_category is not None
            and self.cfg.eval_missing_prob > 0
        ):
            # jitted protocol only: eager anytime_eval dispatches per op
            # (tests/test_lint.py enforces it)
            anytime = anytime_eval_jit(
                self.model, self.state.params, batch, key,
                missing_prob=self.cfg.eval_missing_prob,
            )
            out.update({f"anytime_{k}": float(v) for k, v in anytime.items()})
        print("\n" + " ".join(f"{k}:{v:.4f}" for k, v in sorted(out.items())))
        return out


def multi_scale_schedule(
    sizes: Sequence[Tuple[int, int, int]], it: int, period: int = 3, seed: int = 0
) -> Tuple[int, int, int]:
    """Deterministic multi-scale pick: reshuffle the size list every
    ``period * len(sizes)`` iterations, then walk it ``period`` iterations per
    entry (train_pascal.py:121-124 with seeded RNG instead of global state).
    Callers bucket compiled steps by the returned (rows, cols, batch)."""
    sizes = list(sizes)
    block = period * len(sizes)
    round_idx = it // block
    rng = np.random.default_rng(seed + round_idx)
    order = rng.permutation(len(sizes))
    return sizes[order[(it % block) // period]]
