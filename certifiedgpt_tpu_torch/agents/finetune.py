"""Finetune agent (``image_text_finetune``) and train-time input noise.

Port of ``certifiedgpt_tpu/agents/finetune.py``. A train step draws the
input noise on the device (``add_input_noise``), runs the loss (ViT ->
Q-Former -> projection -> decoder, label-smoothed CE; ``minigpt4_loss``),
backpropagates into the trainable leaves only (``run.trainable_keys``,
default ``["llama_proj"]``: the module's ``nn.Parameter``s; every other
leaf is a frozen buffer, so no graph is kept through the frozen towers),
then steps AdamW (``optim.py``). ``run.pack_sequences`` K packs K samples
into each training row. Validation runs unpacked with
``reduction="none"``, each batch padded to ``batch_size`` by repeating its
last row and the padded rows masked out. Each epoch writes the resume
checkpoint (with the optimizer state) and, when the monitored loss
improves, ``{checkpoint_name}_best``; early stopping after ``patience``
epochs without improvement; ``resume_ckpt_path`` resumes (from either
package's checkpoint); ``loss_history.json`` and its plot at the end;
step-metric rows in ``{checkpoint_name}.txt``. ``run.evaluate`` runs
validation only, ``run.debug_graph_computation`` one step and a
``debug_ckpt``.

Noise keying: each train step's noise comes from a generator seeded by
(seed, epoch, step within the epoch), each validation batch's by (seed,
``VAL_NOISE_KEY``, batch), on the images' device. A resumed run starts its
epoch at step 0 and so draws the same noise as a run that was never
interrupted, with nothing to replay (the JAX package keys by the global
step and restores it). The two packages' generators differ, so their runs
agree only at noise 0.

``run.enable_profile`` traces the train step (``profile_epoch``,
``profile_step``) with ``common/profiling.py``.

Data parallelism (``run.distributed``, the mesh's batch group): each rank
loads its contiguous slice of every global batch (``batch_size`` rows; a
packed run needs ``batch_size / pack_sequences`` rows that divide too) and
draws the whole batch's noise from the step's generator, keeping its rows,
so every sample gets the one-process noise. The loss is the one-process
loss: the per-token losses and the token counts are summed over the batch
group before the division (not a mean of means), so packing and
``real_rows`` weigh right; after the backward the trainable leaves'
gradients are summed over the batch group. AdamW's state stays replicated.
Tensor parallelism (``run.model_parallel``) shards the decoder
(``BaseAgent``). Pipeline parallelism (``run.pipeline_parallel`` P > 1)
keeps this stage's blocks of the decoder (``parallel/pipeline.py``) and
routes the decoder of every train step through the GPipe schedule in
``run.pipeline_microbatches`` microbatches (default 2 x P; they must
divide the decoder rows, and each microbatch the data axis), validation
in one; the batch splits over the data axis only, so the stages of one
pipeline see the same rows.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from certifiedgpt_tpu_torch.agents.base import BaseAgent
from certifiedgpt_tpu_torch.common.metrics import StepMetrics
from certifiedgpt_tpu_torch.common.profiling import Profiler
from certifiedgpt_tpu_torch.common.registry import registry
from certifiedgpt_tpu_torch.data.loader import Loader, to_device
from certifiedgpt_tpu_torch.data.text import (
    BatchSpec,
    build_multiturn_train_batch,
    build_train_batch,
    pack_train_batch,
)
from certifiedgpt_tpu_torch.models.llama import IGNORE_INDEX
from certifiedgpt_tpu_torch.models.minigpt4 import minigpt4_loss
from certifiedgpt_tpu_torch.parallel.mesh import gather_split_leaves, split_leaves
from certifiedgpt_tpu_torch.parallel.pipeline import (
    n_stages,
    pipeline_minigpt4_loss,
    stage_decoder,
)
from certifiedgpt_tpu_torch.smoothing.classifier import chunk_seed

#: the epoch key of the validation batches' noise generators
VAL_NOISE_KEY = 10_000_000


def add_input_noise(images: torch.Tensor, sigma: float, dist: str = "gaussian",
                    generator: torch.Generator = None) -> torch.Tensor:
    """Per-pixel noise drawn on the images' device from ``generator``:
    ``images + sigma * U[0, 1)`` under ``dist="uniform"`` (the reference's
    ``maybe_add_noise``), else ``images + sigma * N(0, 1)``; ``sigma <= 0``
    returns the images unchanged."""
    if sigma <= 0:
        return images
    draw = torch.rand if dist == "uniform" else torch.randn
    return images + sigma * draw(images.shape, generator=generator, device=images.device,
                                 dtype=images.dtype)


def train_loss(model, batch: Dict[str, torch.Tensor], mesh=None, n_micro: int = 1,
               reduction: str = "mean") -> torch.Tensor:
    """The loss a run trains with: ``minigpt4_loss``, or, when the mesh has
    pipe stages, ``pipeline_minigpt4_loss`` at ``n_micro`` microbatches
    (the JAX agent's ``_loss_fn``)."""
    if n_stages(mesh) > 1:
        return pipeline_minigpt4_loss(model.params, model.cfg, batch, mesh, n_micro,
                                      reduction=reduction)
    return minigpt4_loss(model.params, model.cfg, batch, reduction=reduction)


def data_parallel_loss(model, batch: Dict[str, torch.Tensor], params, mesh=None,
                       n_micro: int = 1) -> torch.Tensor:
    """The one-process loss of a batch whose rows are split over the mesh's
    batch group, each rank passing its own: the token losses and the token
    counts summed over the group before the division (not a mean of means,
    so packed rows and uneven counts weigh right). Backpropagates and sums
    the gradients of ``params`` over the group; returns the loss. Without a
    mesh, the same arithmetic in one process. Under pipe stages the decoder
    runs the GPipe schedule in ``n_micro`` microbatches."""
    local = train_loss(model, batch, mesh, n_micro, reduction="sum").sum()
    count = (batch["labels"][:, 1:] != IGNORE_INDEX).sum().float()
    if mesh is not None:
        mesh.batch_sum(count)
    (local / count.clamp_min(1)).backward()
    if mesh is not None:
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            mesh.batch_sum(p.grad)
    total = local.detach().clone()
    if mesh is not None:
        mesh.batch_sum(total)
    return total / count.clamp_min(1)


def data_parallel_step(model, batch: Dict[str, torch.Tensor], optimizer, mesh=None,
                       n_micro: int = 1) -> torch.Tensor:
    """``data_parallel_loss`` over the optimizer's parameters, then one
    optimizer step. Returns the loss."""
    loss = data_parallel_loss(model, batch, optimizer.params, mesh, n_micro)
    optimizer.step()
    return loss


def noise_seed(seed: int, epoch: int, step: int) -> int:
    """Generator seed of one step's noise: (seed, epoch, step)."""
    return chunk_seed(chunk_seed(seed, epoch), step)


@registry.register_agent("image_text_finetune")
class FinetuneAgent(BaseAgent):
    def __init__(self, config, device="cuda"):
        run = config.run
        super().__init__(config, device)
        if self.mesh.n_pipe > 1:
            # run.pipeline_parallel: this rank keeps its stage's blocks
            stage_decoder(self.model, self.mesh)
        self.max_epoch = int(run.get("max_epoch", 1))
        self.patience = int(run.get("patience", 5))
        self.noise_level = float(run.get("noise_level", 0.0))
        self.noise_dist = str(run.get("noise_dist", "gaussian"))
        self.batch_size = int(run.get("batch_size", 4))
        self.seq_len = int(run.get("seq_len", 256))
        # K samples a training row (block-diagonal attention, per-segment
        # positions); validation stays unpacked for per-sample losses
        self.pack = int(run.get("pack_sequences", 1))
        if self.pack < 1:
            raise ValueError(f"run.pack_sequences must be >= 1, got {self.pack}")
        if self.batch_size % self.pack:
            raise ValueError(
                f"run.batch_size={self.batch_size} is not divisible by "
                f"run.pack_sequences={self.pack}"
            )
        # every packed segment gets a fixed seq_len // pack budget, so
        # whether a sample fits is a property of the config: checked here
        seg_budget = self.seq_len // self.pack
        n_img = self.model.cfg.num_img_tokens
        if self.pack > 1 and seg_budget < 1 + n_img + 2:
            raise ValueError(
                f"run.seq_len={self.seq_len} / run.pack_sequences={self.pack} leaves a "
                f"{seg_budget}-token segment budget but bos + {n_img} image tokens + an "
                f"answer needs {1 + n_img + 2} (raise run.seq_len or lower "
                f"run.pack_sequences)"
            )
        max_pos = int(self.model.cfg.llama.max_position_embeddings)
        if self.pack > 1 and seg_budget > max_pos:
            raise ValueError(
                f"run.seq_len={self.seq_len} / run.pack_sequences={self.pack} = a "
                f"{seg_budget}-token segment budget, past the decoder's "
                f"max_position_embeddings={max_pos} rotary table (raise "
                f"model.max_position_embeddings or pack more)"
            )
        # the packed text rows split over the mesh's batch axes like the
        # images: catch a row count they do not divide here, not at step 1
        n_data = self.mesh.batch_divisor
        rows = self.batch_size // self.pack
        if self.pack > 1 and rows % n_data:
            raise ValueError(
                f"run.batch_size={self.batch_size} / run.pack_sequences={self.pack} = "
                f"{rows} packed rows, which does not divide the mesh data axis "
                f"({n_data}); pick batch_size so batch_size/pack_sequences is a "
                "multiple of it"
            )
        if self.batch_size % n_data:
            raise ValueError(
                f"Global batch_size {self.batch_size} must be divisible by the "
                f"mesh data axis ({n_data})"
            )
        # run.pipeline_microbatches (default 2 x stages: bubble (P-1)/(M+P-1))
        # must divide the decoder rows, and each microbatch the data axis
        self.n_pipe = self.mesh.n_pipe
        self.n_micro = (int(run.get("pipeline_microbatches", 2 * self.n_pipe))
                        if self.n_pipe > 1 else 1)
        if self.n_pipe > 1:
            if rows % self.n_micro:
                raise ValueError(
                    f"{rows} decoder rows (batch_size/pack_sequences) do not divide into "
                    f"run.pipeline_microbatches={self.n_micro}")
            if (rows // self.n_micro) % n_data:
                raise ValueError(
                    f"a {rows // self.n_micro}-row microbatch does not divide the mesh data "
                    f"axis ({n_data}); lower run.pipeline_microbatches or the data degree")
        self.seed = int(run.get("seed", 42))
        self.trainable_keys = tuple(run.get("trainable_keys", ["llama_proj"]))
        self.trainable = self.model.make_trainable(self.trainable_keys)
        self.optimizer = self.build_optimizer(self.trainable)
        self.wandb_run = self._setup_wandb()
        self.profiler = Profiler(run, device)
        self.metrics = StepMetrics(self.output_dir, str(run.get("checkpoint_name", "metrics")))
        self.metrics.track("train_step", self._train_step)

    # ------------------------------------------------------------------
    def _setup_wandb(self):
        if not self.run_cfg.get("wandb", False) or not self.is_writer:
            return None  # one wandb run, owned by rank 0
        try:
            import wandb

            run = wandb.init(project=str(self.run_cfg.get("wandb_name", "certifiedgpt_tpu")),
                             config=self.config.to_dict())
            try:
                run.define_metric("epoch")
                for metric in ("train_loss", "val_loss", "learning_rate", "param_norm"):
                    run.define_metric(metric, step_metric="epoch")
            except Exception:  # older wandb without define_metric
                pass
            return run
        except Exception as exc:
            self.logger.warning("wandb unavailable: %s", exc)
            return None

    def _generator(self, epoch: int, step: int) -> torch.Generator:
        generator = torch.Generator(device=self.device)
        generator.manual_seed(noise_seed(self.seed, epoch, step))
        return generator

    def _noisy(self, batch: Dict[str, torch.Tensor], generator,
               per: int = None) -> Dict[str, torch.Tensor]:
        """The batch with its images' noise: the whole batch's noise
        (``batch_size`` rows) is drawn and this rank keeps the rows of its
        samples, which start at ``batch_index * per`` (``per``: the
        loader's rows a rank, the batch's rows when None; one process
        keeps rows from 0)."""
        images = batch["image"]
        whole = torch.zeros((self.batch_size,) + tuple(images.shape[1:]), dtype=images.dtype,
                            device=images.device)
        noise = add_input_noise(whole, self.noise_level, self.noise_dist, generator)
        start = self.mesh.batch_index * (images.shape[0] if per is None else per)
        return dict(batch, image=images + noise[start:start + images.shape[0]])

    def _train_step(self, batch: Dict[str, torch.Tensor], generator) -> torch.Tensor:
        """One step: noise, loss, backward into the trainable leaves, an
        optimizer step (``data_parallel_step``: the loss is the sum of every
        rank's token losses over the sum of their token counts, and the
        gradients are summed over the batch group before the step). Returns
        the loss (on the device)."""
        return data_parallel_step(self.model, self._noisy(batch, generator), self.optimizer,
                                  self.mesh, self.n_micro)

    @torch.no_grad()
    def _eval_step(self, batch, valid: torch.Tensor, generator, per: int = None):
        """Sum of the per-sample losses over the valid rows, and their count
        (under pipe stages in one microbatch: the padded val batch need not
        divide the train setting)."""
        losses = train_loss(self.model, self._noisy(batch, generator, per), self.mesh,
                            n_micro=1, reduction="none")
        v = valid.to(losses.dtype)
        return (losses * v).sum(), v.sum()

    # ------------------------------------------------------------------
    def create_loaders(self) -> Dict[str, Loader]:
        loaders: Dict[str, Loader] = {}
        for name in self.config.datasets.keys():
            builder_cls = registry.get_builder_class(name)
            if builder_cls is None:
                raise KeyError(f"Unknown builder '{name}'")
            for split, dataset in builder_cls().build_datasets().items():
                if split in loaders:
                    self.logger.warning(
                        "dataset '%s' also provides split '%s'; keeping the first "
                        "configured dataset (one dataset per finetune run)", name, split,
                    )
                    continue
                if self.model.prompt_list and hasattr(dataset, "set_prompts"):
                    dataset.set_prompts(self.model.prompt_list)
                # train drops the remainder (one shape a step); val keeps it
                loaders[split] = Loader(
                    dataset, batch_size=self.batch_size, shuffle=(split == "train"),
                    drop_last=(split == "train"), seed=self.seed,
                    num_workers=int(self.run_cfg.get("num_workers", 4)),
                    process_index=self.mesh.batch_index,
                    process_count=self.mesh.batch_divisor,
                )
        return loaders

    def device_batch(self, host_batch: Dict[str, Any], pack: int = 0) -> Dict[str, torch.Tensor]:
        """The host batch's text arrays (packed K to a row when ``pack`` >
        1; a multi-turn batch by conversation) and images, on the device."""
        pack = pack or self.pack
        spec = BatchSpec(seq_len=self.seq_len, num_img_tokens=self.model.cfg.num_img_tokens,
                         max_answer_len=self.model.cfg.max_txt_len)
        tok = self.model.tokenizer
        if "turns" in host_batch:
            if pack > 1:
                raise ValueError(
                    "run.pack_sequences does not support multi-turn conversation datasets "
                    "(each row already carries one long conversation)"
                )
            text = build_multiturn_train_batch(tok, host_batch["turns"], spec)
        elif pack > 1:
            text = pack_train_batch(tok, host_batch["instruction_input"], host_batch["answer"],
                                    spec, pack)
        else:
            text = build_train_batch(tok, host_batch["instruction_input"],
                                     host_batch["answer"], spec)
        arrays = {"image": host_batch["image"].astype(np.float32),
                  **{k: v.astype(np.int64) for k, v in text.items()}}
        return to_device(arrays, self.device)

    # ------------------------------------------------------------------
    def debug_graph_computation(self) -> Dict[str, Any]:
        """One forward/backward/update on the first train batch and a
        ``debug_ckpt`` checkpoint."""
        batch = dict(next(iter(self.create_loaders()["train"])))
        batch.pop("__local_real_rows__", None)
        loss = float(self._train_step(self.device_batch(batch), self._generator(0, 0)))
        self.logger.info("debug_graph_computation: loss=%.4f", loss)
        self.save_agent_checkpoint("debug_ckpt", self.trainable, self.optimizer, epoch=0)
        self.metrics.log_event(f"debug_graph_computation loss={loss:.4f}")
        return {"loss": loss, "steps": 1}

    @staticmethod
    def _pad_host_batch(batch, pad_to: int):
        """Every field of a host batch padded to ``pad_to`` rows by
        repeating the last row; returns (padded batch, real rows)."""
        n = len(next(iter(batch.values())))
        if n >= pad_to:
            return batch, n
        reps = pad_to - n
        out = {}
        for key, val in batch.items():
            if isinstance(val, np.ndarray):
                out[key] = np.concatenate([val, np.repeat(val[-1:], reps, 0)])
            else:
                out[key] = list(val) + [val[-1]] * reps
        return out, n

    def _run_validation(self, val_loader) -> float:
        """Sample-weighted mean loss over the val split, unpacked, each
        batch padded to ``batch_size`` rows (this rank's share of them
        under data parallelism) with the padded rows and the loader's
        wrapped duplicates (``__local_real_rows__``) masked; the sums are
        summed over the batch group."""
        v_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        v_rows = torch.zeros((), dtype=torch.float32, device=self.device)
        pad_to = self.batch_size // self.mesh.batch_divisor
        for index, batch in enumerate(val_loader):
            batch = dict(batch)
            real_rows = batch.pop("__local_real_rows__", None)
            per = len(batch["image"])
            batch, rows = self._pad_host_batch(batch, pad_to)
            if real_rows is not None:
                rows = min(rows, int(real_rows))
            valid = torch.zeros((pad_to,), dtype=torch.int32, device=self.device)
            valid[:rows] = 1
            loss_sum, count = self._eval_step(self.device_batch(batch, pack=1), valid,
                                              self._generator(VAL_NOISE_KEY, index), per)
            v_sum += loss_sum
            v_rows += count
        self.mesh.batch_sum(v_sum)
        self.mesh.batch_sum(v_rows)
        if float(v_rows) == 0:
            raise RuntimeError(
                "validation split produced no batches; check the val dataset "
                "configuration or set run.has_val_split: false"
            )
        return float(v_sum) / float(v_rows)

    def _resume(self, path: str):
        """(first epoch, global step) after restoring the trainable leaves
        and the optimizer state of ``path``; (0, 0) when it is missing."""
        # a checkpoint holds the decoder whole: this rank keeps its part
        template = gather_split_leaves(self.trainable, self.mesh, self.device)
        try:
            trainable, opt_state, meta = self.load_agent_checkpoint(path, template)
        except FileNotFoundError:
            self.logger.info("No resume checkpoint at %s; fresh start", path)
            return 0, 0
        trainable, opt_state = split_leaves(trainable, self.mesh), split_leaves(opt_state,
                                                                                 self.mesh)
        with torch.no_grad():
            for key, tree in trainable.items():
                _copy_tree(self.trainable[key], tree)
        if opt_state is not None:
            self.optimizer.load_state_arrays(opt_state)
        start_epoch = int(meta.get("epoch", -1)) + 1
        self.logger.info("Resumed from %s at epoch %d", path, start_epoch)
        return start_epoch, int(meta.get("global_step", 0))

    def run(self) -> Dict[str, Any]:
        run = self.run_cfg
        if run.get("debug_graph_computation", False):
            return self.debug_graph_computation()
        loaders = self.create_loaders()
        train_loader = loaders.get("train")
        val_loader = loaders.get("val") if run.get("has_val_split", True) else None
        evaluate_only = bool(run.get("evaluate", False))
        if train_loader is None and not evaluate_only:
            raise RuntimeError("No train split configured")

        start_epoch, start_step = 0, 0
        resume = run.get("resume_ckpt_path")
        if resume:
            start_epoch, start_step = self._resume(str(resume))

        if evaluate_only:
            if val_loader is None:
                raise RuntimeError("run.evaluate needs a val split")
            val_loss = self._run_validation(val_loader)
            self.record_loss("val", val_loss)
            self.logger.info("evaluate-only: val_loss %.4f", val_loss)
            self.save_history()
            return {"val_loss": val_loss, "epochs": 0, "evaluate_only": True}

        ckpt_name = str(run.get("checkpoint_name", "checkpoint"))
        best_val = float("inf")
        bad_epochs = 0
        global_step = start_step
        max_iters = run.get("iters_per_epoch")
        epoch = start_epoch - 1  # stays if the loop body never runs
        for epoch in range(start_epoch, self.max_epoch):
            train_loader.set_epoch(epoch)
            epoch_loss, n_steps = 0.0, 0
            t0 = time.time()
            for batch in train_loader:
                batch = dict(batch)
                batch.pop("__local_real_rows__", None)  # train batches are whole
                self.profiler.maybe_start(epoch, n_steps)
                loss = float(self._train_step(self.device_batch(batch),
                                              self._generator(epoch, n_steps)))
                self.metrics.log_step_metrics("train", epoch, n_steps, loss,
                                              lr=float(self.lr_schedule(global_step)))
                epoch_loss += loss
                n_steps += 1
                global_step += 1
                if max_iters and n_steps >= int(max_iters):
                    break
            train_loss = epoch_loss / max(n_steps, 1)
            self.record_loss("train", train_loss)
            dt = time.time() - t0
            self.logger.info("epoch %d train_loss %.4f (%d steps, %.1fs, %.2f steps/s)",
                             epoch, train_loss, n_steps, dt, n_steps / max(dt, 1e-9))

            val_loss = None
            if val_loader is not None:
                val_loss = self._run_validation(val_loader)
                self.record_loss("val", val_loss)
                self.logger.info("epoch %d val_loss %.4f", epoch, val_loss)

            monitored = val_loss if val_loss is not None else train_loss
            if self.stateful_lr:
                new_lr = self.lr_schedule.step_metric(monitored)
                self.optimizer.set_learning_rate(new_lr)
                self.logger.info("plateau scheduler lr -> %.2e", new_lr)
            if self.wandb_run is not None:
                self._log_wandb(epoch, train_loss, val_loss, global_step)

            # the resume checkpoint every epoch, with the optimizer state
            self.save_agent_checkpoint(ckpt_name, self.trainable, self.optimizer, epoch=epoch,
                                       global_step=global_step)
            if monitored < best_val:
                best_val = monitored
                bad_epochs = 0
                self.save_agent_checkpoint(f"{ckpt_name}_best", self.trainable, epoch=epoch,
                                           val_loss=monitored)
            else:
                bad_epochs += 1
                if bad_epochs >= self.patience:
                    self.logger.info("Early stopping at epoch %d (patience %d)",
                                     epoch, self.patience)
                    break

        self.save_history()
        # "steps": steps run in this invocation (a resume with nothing left: 0)
        return {"best_val": best_val, "epochs": epoch + 1, "steps": global_step - start_step}

    def _log_wandb(self, epoch, train_loss, val_loss, global_step) -> None:
        param_norm = float(torch.sqrt(sum((p.float() ** 2).sum() for p in self.optimizer.params)))
        lr = self.optimizer.current_lr() if self.stateful_lr \
            else float(self.lr_schedule(global_step))
        self.wandb_run.log({"epoch": epoch, "train_loss": train_loss, "learning_rate": lr,
                            "param_norm": param_norm,
                            **({"val_loss": val_loss} if val_loss is not None else {})})


def _copy_tree(dst, src) -> None:
    for key, value in src.items():
        if isinstance(value, dict):
            _copy_tree(dst[key], value)
        else:
            dst[key].copy_(value)
