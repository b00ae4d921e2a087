"""Mapper fine-tune — the trainer whose checkpoint the product serves
(reference: src/cli/train_caption_mapper.py:165-326).

Semantics preserved: ViT and GPT-2 frozen, ``proj`` + ``mapper`` trained at
``lr`` (optionally the last N GPT-2 blocks at ``lr_gpt2``); teacher-forcing
loss identical to the generate path (compute_loss_local :88-129); periodic
validation with best-val checkpointing; events.csv / val.csv metrics files.

The step is one jitted SPMD program over the device mesh — batch
sharded over the data axis, parameters sharded by the TP rules
(parallel/mesh.py); XLA inserts the gradient psum over "data". This is the
multi-device capability the reference lacks entirely (SURVEY §2.9).
"""
from __future__ import annotations

import csv
import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator, Optional

import jax
import optax

from video_caption_tpu.models import caption_model as cm
from video_caption_tpu.parallel import mesh as pmesh
from video_caption_tpu.training import optim as topt
from video_caption_tpu.training.checkpoint import save_checkpoint

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class TrainArgs:
    lr: float = 3e-4
    lr_gpt2: float = 1e-5
    unfreeze_last_gpt2: int = 0
    weight_decay: float = 0.01
    epochs: int = 1
    max_steps: int = 0              # 0 = no cutoff
    val_every: int = 200
    max_val_batches: int = 50       # reference evaluate() cap (:20-32)
    out_dir: str = "runs/mapper"
    ckpt_path: str = "checkpoints/msvd_mapper_finetune"


def make_train_step(cfg: cm.CaptionModelConfig, optimizer: optax.GradientTransformation):
    """Returns jitted (params, opt_state, batch) -> (params, opt_state, loss)."""

    def step(params, opt_state, batch):
        def loss_fn(p):
            return cm.compute_loss(
                p, batch["video"], batch["caption_ids"], batch["attention_mask"], cfg
            )

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return jax.jit(step, donate_argnums=(0, 1))


def make_eval_step(cfg: cm.CaptionModelConfig):
    def step(params, batch):
        return cm.compute_loss(
            params, batch["video"], batch["caption_ids"], batch["attention_mask"], cfg
        )

    return jax.jit(step)


class MapperTrainer:
    def __init__(
        self,
        cfg: cm.CaptionModelConfig,
        params: Any,
        args: TrainArgs = TrainArgs(),
        mesh: Optional[jax.sharding.Mesh] = None,
        fsdp: bool = False,
        fsdp_min_elems: Optional[int] = None,
    ):
        import dataclasses

        # ViT always frozen in this trainer (reference :199-207): stop-grad
        # the encoder so XLA drops its backward pass entirely
        cfg = dataclasses.replace(cfg, freeze_encoder=True)
        self.cfg = cfg
        self.args = args
        self.mesh = mesh or pmesh.make_mesh()
        # own copy: the train step DONATES its param buffers, and device_put
        # inside shard_params can alias the caller's arrays zero-copy — a
        # donated alias would delete the caller's params out from under them
        import jax.numpy as jnp

        params = jax.tree.map(jnp.array, params)
        shard_kwargs = {} if fsdp_min_elems is None else {"fsdp_min_elems": fsdp_min_elems}
        self.params = pmesh.shard_params(params, self.mesh, fsdp=fsdp, **shard_kwargs)
        lr_tree = topt.mapper_lr_tree(
            self.params, args.lr, args.lr_gpt2, args.unfreeze_last_gpt2, cfg.gpt2.n_layer
        )
        self.optimizer = topt.build_optimizer(lr_tree, args.weight_decay)
        self.opt_state = self.optimizer.init(self.params)
        self.train_step = make_train_step(cfg, self.optimizer)
        self.eval_step = make_eval_step(cfg)
        self.step = 0
        self.best_val = float("inf")
        self._pending: list = []
        out = Path(args.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        self._events = out / "events.csv"
        self._val = out / "val.csv"
        for f, header in ((self._events, ["step", "loss"]), (self._val, ["step", "val_loss"])):
            if not f.exists():
                with f.open("w", newline="") as fh:
                    csv.writer(fh).writerow(header)

    def _log_csv(self, path: Path, row) -> None:
        with path.open("a", newline="") as fh:
            csv.writer(fh).writerow(row)

    def run_step(self, batch: Dict[str, Any], sync: bool = True) -> float:
        """One optimizer step. ``sync=False`` defers the loss materialization
        (``float(loss)`` blocks on the device): ``fit`` dispatches step N+1's
        transfer + compute before reading step N's loss, so the prefetch
        thread's host work and the host->device copy overlap device compute
        instead of serializing behind a per-step sync."""
        batch = pmesh.shard_batch(batch, self.mesh)
        self.params, self.opt_state, loss = self.train_step(self.params, self.opt_state, batch)
        self.step += 1
        if not sync:
            self._pending.append((self.step, loss))
            return self.drain_pending(keep=1)
        loss = float(loss)
        self._log_csv(self._events, [self.step, loss])
        return loss

    def drain_pending(self, keep: int = 0) -> float:
        """Materialize deferred losses older than the last ``keep`` steps;
        returns the most recently materialized loss (nan if none yet)."""
        last = float("nan")
        while len(self._pending) > keep:
            step, loss = self._pending.pop(0)
            last = float(loss)
            self._log_csv(self._events, [step, last])
        return last

    def evaluate(self, val_iter: Iterator[Dict[str, Any]]) -> float:
        total, count = 0.0, 0
        for i, batch in enumerate(val_iter):
            if i >= self.args.max_val_batches:
                break
            batch = pmesh.shard_batch(batch, self.mesh)
            total += float(self.eval_step(self.params, batch))
            count += 1
        val = total / max(count, 1)
        self._log_csv(self._val, [self.step, val])
        return val

    def maybe_checkpoint(self, val_loss: float, epoch: int) -> bool:
        """Best-val checkpointing (reference :293-306)."""
        if val_loss < self.best_val:
            self.best_val = val_loss
            save_checkpoint(
                self.args.ckpt_path, self.params, step=self.step, epoch=epoch,
                best_val=self.best_val, args=vars(self.args) if hasattr(self.args, "__dict__") else {},
            )
            return True
        return False

    def fit(self, train_loader, val_loader=None) -> Dict[str, float]:
        t0 = time.time()
        for epoch in range(self.args.epochs):
            for batch in train_loader:
                loss = self.run_step(batch, sync=False)
                if self.args.max_steps and self.step >= self.args.max_steps:
                    break
                if val_loader is not None and self.step % self.args.val_every == 0:
                    loss = self.drain_pending()
                    val = self.evaluate(iter(val_loader))
                    self.maybe_checkpoint(val, epoch)
                    log.info("step %d loss %.4f val %.4f", self.step, loss, val)
            if self.args.max_steps and self.step >= self.args.max_steps:
                break
        self.drain_pending()
        if val_loader is not None:
            val = self.evaluate(iter(val_loader))
            self.maybe_checkpoint(val, self.args.epochs)
        return {"steps": self.step, "best_val": self.best_val, "wall_s": time.time() - t0}
