"""Learning-rate schedules and AdamW, as the JAX package's ``optim.py``
(optax) defines them.

- The schedules are copies, under the same registry names:
  ``linear_warmup_cosine_lr``, ``constant_lr`` and the host-stateful
  ``reduce_lr_on_plateau``. Each computes in float32, as the JAX
  package's ``jnp`` schedules do.
- ``AdamW`` is the optax chain ``make_optimizer`` builds, written out:
  ``clip_by_global_norm`` (optax's formula: ``t / norm * max_norm`` when
  ``norm >= max_norm``, no epsilon), ``scale_by_adam`` (moments in the
  parameters' dtype, bias correction by the count after its increment),
  ``add_decayed_weights`` on the decayed parameter group only, and the
  learning rate of ``schedule(count)`` with the count before its
  increment. ``accumulate_steps`` k > 1 is ``optax.MultiSteps``: every call
  folds the gradient into a running mean, and every k-th call applies the
  chain to that mean.
- The weight-decay mask (``weight_decay_mask``, by path) becomes two
  parameter groups, with and without decay (``param_groups``).
- ``AdamW.state_arrays`` and ``load_state_arrays`` write and read the
  optimizer state under the paths of the optax state the JAX package
  checkpoints (``count``/``mu``/``nu`` under their chain indices), so
  either package resumes the other's run.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from certifiedgpt_tpu_torch.common.checkpoint import array_to_tensor, tensor_to_array
from certifiedgpt_tpu_torch.common.registry import registry

_NO_DECAY_LEAF_NAMES = ("bias", "scale", "q_bias", "v_bias")
_NO_DECAY_PATH_HINTS = ("ln", "norm", "embeddings_ln")

_F32 = np.float32


def flatten_tree(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    """``[(path, leaf)]`` of a nested dict in its insertion order."""
    out = []
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out += flatten_tree(value, path)
        else:
            out.append((path, value))
    return out


def decays(path: Tuple[str, ...], leaf: torch.Tensor) -> bool:
    """True where weight decay applies: kernels of two or more dimensions
    outside norms (``weight_decay_mask`` of the JAX package)."""
    if leaf.dim() < 2:
        return False
    if path and path[-1] in _NO_DECAY_LEAF_NAMES:
        return False
    joined = "/".join(path).lower()
    return not any(h in joined for h in _NO_DECAY_PATH_HINTS)


def param_groups(tree: Mapping[str, Any], weight_decay: float) -> List[Dict[str, Any]]:
    """The trainable tree's leaves as two parameter groups: those that
    decay (``weight_decay``) and those that do not (0). Each group lists
    its ``params`` and their ``paths``."""
    groups = [{"params": [], "paths": [], "weight_decay": float(weight_decay)},
              {"params": [], "paths": [], "weight_decay": 0.0}]
    for path, leaf in flatten_tree(tree):
        group = groups[0] if decays(path, leaf) else groups[1]
        group["params"].append(leaf)
        group["paths"].append(path)
    return [g for g in groups if g["params"]]


# ----------------------------------------------------------------------
# schedules
# ----------------------------------------------------------------------
@registry.register_lr_scheduler("linear_warmup_cosine_lr")
class LinearWarmupCosineLR:
    """Linear warmup from ``warmup_start_lr`` to ``warmup_max_lr`` over
    ``warmup_steps``, then cosine decay from ``init_lr`` to ``min_lr`` over
    ``max_epoch * iters_per_epoch`` steps (by the global step)."""

    def __init__(self, max_epoch: int, iters_per_epoch: int, min_lr: float, init_lr: float,
                 warmup_steps: int = 0, warmup_start_lr: float = -1.0,
                 warmup_max_lr: float = 0.0, **_unused):
        self.total_steps = max_epoch * iters_per_epoch
        self.min_lr = float(min_lr)
        self.init_lr = float(init_lr)
        self.warmup_steps = int(warmup_steps)
        self.warmup_start_lr = float(warmup_start_lr if warmup_start_lr >= 0 else init_lr)
        self.warmup_max_lr = float(warmup_max_lr)

    def __call__(self, step) -> float:
        step = _F32(step)
        warm = _F32(self.warmup_start_lr) + _F32(self.warmup_max_lr - self.warmup_start_lr) \
            * step / _F32(max(self.warmup_steps, 1))
        warm = min(_F32(self.warmup_max_lr), warm)
        cos = _F32(self.min_lr) + _F32(self.init_lr - self.min_lr) * _F32(0.5) * (
            _F32(1.0) + np.cos(_F32(math.pi) * step / _F32(max(self.total_steps, 1))))
        return float(warm if step < self.warmup_steps else cos)


@registry.register_lr_scheduler("constant_lr")
class ConstantLR:
    def __init__(self, init_lr: float, **_unused):
        self.init_lr = float(init_lr)

    def __call__(self, step) -> float:
        return float(_F32(self.init_lr))


@registry.register_lr_scheduler("reduce_lr_on_plateau")
class ReduceLROnPlateau:
    """Host-stateful plateau scheduler: the agent reports the monitored
    metric each epoch (``step_metric``), which returns the learning rate;
    the optimizer takes it through ``set_learning_rate``."""

    def __init__(self, init_lr: float, min_lr: float = 0.0, factor: float = 0.1,
                 plateau_patience: int = 2, threshold: float = 1e-4, **_unused):
        self.init_lr = float(init_lr)
        self.min_lr = float(min_lr)
        self.factor = float(factor)
        self.patience = int(plateau_patience)
        self.threshold = float(threshold)
        self._scale = 1.0
        self._best = float("inf")
        self._bad = 0

    @property
    def current_lr(self) -> float:
        return max(self.init_lr * self._scale, self.min_lr)

    def step_metric(self, value: float) -> float:
        """Report the monitored metric (lower is better); returns the lr."""
        if value < self._best - self.threshold:
            self._best = value
            self._bad = 0
        else:
            self._bad += 1
            if self._bad > self.patience:
                self._scale *= self.factor
                self._bad = 0
        return self.current_lr

    def __call__(self, step) -> float:
        return float(_F32(self.current_lr))


def build_lr_schedule(run_cfg) -> Any:
    """The scheduler that ``run.lr_sched`` names, from the run block."""
    name = run_cfg.get("lr_sched", "linear_warmup_cosine_lr")
    sched_cls = registry.get_lr_scheduler_class(name)
    if sched_cls is None:
        raise KeyError(f"Unknown lr scheduler '{name}'")
    return sched_cls(
        max_epoch=int(run_cfg.get("max_epoch", 1)),
        iters_per_epoch=int(run_cfg.get("iters_per_epoch", 1)),
        min_lr=float(run_cfg.get("min_lr", 1e-6)),
        init_lr=float(run_cfg.get("init_lr", 1e-5)),
        warmup_steps=int(run_cfg.get("warmup_steps", 0)),
        warmup_start_lr=float(run_cfg.get("warmup_start_lr", -1)),
        warmup_max_lr=float(run_cfg.get("warmup_max_lr", 0.0)),
        factor=float(run_cfg.get("plateau_factor", 0.1)),
        plateau_patience=int(run_cfg.get("plateau_patience", 2)),
        threshold=float(run_cfg.get("plateau_threshold", 1e-4)),
    )


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------
def _grad_norm_sq(paths, grads: List[torch.Tensor]) -> torch.Tensor:
    return sum(torch.sum(g.float() * g.float()) for g in grads)


class AdamW:
    """AdamW with optax's arithmetic (module docstring) over the tensors
    of ``tree`` (``nn.Parameter``s, updated in place). ``step()`` reads
    each parameter's ``.grad``, then clears it. With ``stateful_lr`` the
    learning rate is a value that ``set_learning_rate`` changes (optax's
    ``inject_hyperparams``), else ``schedule(count)``."""

    def __init__(self, tree: Mapping[str, Any], schedule, weight_decay: float = 0.05,
                 beta1: float = 0.9, beta2: float = 0.999, accumulate_steps: int = 1,
                 max_grad_norm: Optional[float] = None, stateful_lr: bool = False,
                 eps: float = 1e-8, grad_norm_sq=None):
        if stateful_lr:
            # inject_hyperparams holds every hyperparameter as an f32 array
            weight_decay, beta1, beta2, eps = (float(_F32(v)) for v in
                                               (weight_decay, beta1, beta2, eps))
        self.param_groups = param_groups(tree, weight_decay)
        self.schedule = schedule
        self.weight_decay = float(weight_decay)
        self.b1, self.b2, self.eps = float(beta1), float(beta2), float(eps)
        self.k = int(accumulate_steps)
        self.max_grad_norm = float(max_grad_norm) if max_grad_norm else None
        # (paths, grads) -> the squared global norm; ranks that hold parts
        # of a leaf sum them (parallel/mesh.split_grad_norm_sq)
        self.grad_norm_sq = grad_norm_sq or _grad_norm_sq
        self.stateful_lr = bool(stateful_lr)
        self.lr = float(_F32(schedule(0))) if stateful_lr else None
        self.count = 0  # scale_by_adam's count (inject_hyperparams' too)
        self.sched_count = 0  # scale_by_schedule's count
        self.mini_step = 0  # MultiSteps
        self.gradient_step = 0
        params = self.params
        self.mu = [torch.zeros_like(p, memory_format=torch.preserve_format) for p in params]
        self.nu = [torch.zeros_like(p, memory_format=torch.preserve_format) for p in params]
        self.acc = [torch.zeros_like(p) for p in params] if self.k > 1 else None

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    @property
    def paths(self) -> List[Tuple[str, ...]]:
        return [path for g in self.param_groups for path in g["paths"]]

    def _decay(self) -> List[float]:
        return [g["weight_decay"] for g in self.param_groups for _ in g["params"]]

    def set_learning_rate(self, lr: float) -> None:
        """The learning rate of the next steps (``reduce_lr_on_plateau``);
        only with ``stateful_lr``, as in the JAX package."""
        if not self.stateful_lr:
            raise ValueError("set_learning_rate needs stateful_lr (a host-stateful schedule)")
        self.lr = float(_F32(lr))

    def current_lr(self) -> float:
        """The learning rate the next applied update uses."""
        return self.lr if self.stateful_lr else float(self.schedule(self.sched_count))

    @torch.no_grad()
    def step(self) -> None:
        params = self.params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        for p in params:
            p.grad = None
        if self.k > 1:
            # optax.MultiSteps: a running mean, the chain applied every k-th call
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g.to(a.dtype) - a) / (n + 1))
            if n < self.k - 1:
                self.mini_step += 1
                return
            grads = self.acc
            self.mini_step = 0
            self.gradient_step += 1
        self._apply(params, grads)
        if self.k > 1:
            for a in self.acc:
                a.zero_()

    def _apply(self, params, grads) -> None:
        if self.max_grad_norm is not None:
            norm = torch.sqrt(self.grad_norm_sq(self.paths, grads))
            if not bool(norm < self.max_grad_norm):
                grads = [(g / norm.to(g.dtype)) * self.max_grad_norm for g in grads]
        lr = self.current_lr()
        self.count += 1
        self.sched_count += 1
        c1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32) ** self.count
        c2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32) ** self.count
        for p, g, mu, nu, wd in zip(params, grads, self.mu, self.nu, self._decay()):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            mu_hat = mu / c1.to(device=mu.device, dtype=mu.dtype)
            nu_hat = nu / c2.to(device=nu.device, dtype=nu.dtype)
            update = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            if wd:
                update = update + wd * p
            update = torch.tensor(-lr, dtype=torch.float32).to(update.dtype) * update
            p.copy_((p + update).to(p.dtype))

    # ------------------------------------------------------------------
    # the optax state layout of the JAX package's checkpoints
    # ------------------------------------------------------------------
    def _layout(self) -> Tuple[str, str]:
        """(outer, adam) path prefixes: MultiSteps' inner state, the chain
        index of the AdamW (after a clip, 1), inject_hyperparams' inner
        state."""
        outer = "inner_opt_state/" if self.k > 1 else ""
        outer += "1/" if self.max_grad_norm is not None else "0/"
        adam = outer + ("inner_state/0/" if self.stateful_lr else "0/")
        return outer, adam

    def state_arrays(self) -> Dict[str, np.ndarray]:
        """The optimizer state as the JAX package flattens its optax state
        (the keys without their ``opt:`` prefix), as numpy arrays; bf16
        moments go as f32 (exact), which both packages' readers cast back."""
        outer, adam = self._layout()
        out: Dict[str, np.ndarray] = {}
        if self.k > 1:
            out["mini_step"] = np.asarray(self.mini_step, np.int32)
            out["gradient_step"] = np.asarray(self.gradient_step, np.int32)
        out[adam + "count"] = np.asarray(self.count, np.int32)
        for name, moments in (("mu", self.mu), ("nu", self.nu)):
            for path, t in zip(self.paths, moments):
                out[f"{adam}{name}/" + "/".join(path)] = tensor_to_array(t)
        if self.stateful_lr:
            out[outer + "count"] = np.asarray(self.count, np.int32)
            hyper = {"b1": self.b1, "b2": self.b2, "eps": self.eps, "eps_root": 0.0,
                     "learning_rate": self.lr, "weight_decay": self.weight_decay}
            for name, value in hyper.items():
                out[f"{outer}hyperparams/{name}"] = np.asarray(value, np.float32)
        else:
            out[outer + "2/count"] = np.asarray(self.sched_count, np.int32)
        if self.k > 1:
            for path, t in zip(self.paths, self.acc):
                out["acc_grads/" + "/".join(path)] = tensor_to_array(t)
        return out

    def load_state_arrays(self, flat: Mapping[str, np.ndarray]) -> None:
        """Restore the state from ``state_arrays``' keys (from either
        package's checkpoint); a missing key or a shape that differs
        raises, as the JAX package's template check does."""
        want = self.state_arrays()
        for key, like in want.items():
            if key not in flat:
                raise KeyError(f"Checkpoint missing array for 'opt:{key}'")
            if np.shape(flat[key]) != like.shape:
                raise ValueError(f"Shape mismatch for 'opt:{key}': ckpt "
                                 f"{np.shape(flat[key])} vs optimizer {like.shape}")
        outer, adam = self._layout()
        self.count = int(flat[adam + "count"])
        if self.stateful_lr:
            self.lr = float(np.asarray(flat[outer + "hyperparams/learning_rate"], np.float32))
            self.sched_count = self.count
        else:
            self.sched_count = int(flat[outer + "2/count"])
        if self.k > 1:
            self.mini_step = int(flat["mini_step"])
            self.gradient_step = int(flat["gradient_step"])
        for name, moments in (("mu", self.mu), ("nu", self.nu)):
            for path, t in zip(self.paths, moments):
                t.copy_(array_to_tensor(flat[f"{adam}{name}/" + "/".join(path)], t))
        if self.k > 1:
            for path, t in zip(self.paths, self.acc):
                t.copy_(array_to_tensor(flat["acc_grads/" + "/".join(path)], t))
