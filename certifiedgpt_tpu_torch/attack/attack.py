"""Targeted black-box attack evaluation (AttackVLM-style).

Port of ``certifiedgpt_tpu/attack/attack.py``:

1. **Transfer stage**, ``make_pgd_attack``: sign-gradient steps on the
   pixels inside an l-inf ball around the clean image, minimizing the mean
   cosine distance between the adversary's surrogate embeddings and the
   target's. Each pixel image is resized to the surrogate's size
   (bilinear, anti-aliased when it downsamples, as ``jax.image.resize``,
   by two contractions with the filter's weights) and CLIP-normalized
   inside the loss. One step is the ensemble loss,
   ``torch.autograd.grad`` with respect to the pixels alone (the surrogate
   parameters take no gradient), and the signed step clamped into the ball,
   in place on fixed tensors (``_pgd_step``). On the card that step is
   captured once into a CUDA graph and replayed ``steps`` times, the
   counterpart of the JAX package's ``lax.scan`` inside ``jax.jit``; on the
   CPU it runs eagerly.
2. **Query stage**, ``rgf_refine``: derivative-free refinement against the
   victim with random-gradient-free two-point estimates (numpy, a copy of
   the JAX package's, the same ``np.random.default_rng(seed)`` stream).
3. **Scoring**: ``attack_success`` and the OLS ``ancova`` (numpy/scipy
   copies).

The surrogates are float32 in the JAX package. Their forward and backward
run here inside ``exact_f32``, which turns TF32 off for CUDA matmuls and
cuDNN convolutions and asks cuDNN for its deterministic algorithms for the
duration of the block and restores the caller's settings after it, so the
CLI and the chip script compute the same f32 products whatever the
process-wide flags are, and a PGD loop on the card repeats bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from scipy import stats as sps

from certifiedgpt_tpu_torch.common.graphs import Captured, GraphStore
from certifiedgpt_tpu_torch.data.processors import CLIP_MEAN, CLIP_STD
from certifiedgpt_tpu_torch.models.layers import tree_addresses


@contextlib.contextmanager
def exact_f32():
    """f32 CUDA matmuls and convolutions without TF32 inside the block, and
    cuDNN's deterministic convolution algorithms (its others may sum a
    backward with atomics), so that a PGD loop repeats bit for bit."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cudnn.deterministic = deterministic


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + eps)
    b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + eps)
    return torch.sum(a * b, dim=-1)


@dataclasses.dataclass
class SurrogateEncoder:
    """One member of the attack ensemble."""

    name: str
    apply_fn: Callable  # (params, images_normalized) -> embeddings
    params: Any
    image_size: int = 224


@functools.lru_cache(maxsize=None)
def _clip_stats(device: torch.device):
    """CLIP's mean and std on ``device``, made once (a copy to the card
    has no place inside a captured step)."""
    return (torch.tensor(CLIP_MEAN, dtype=torch.float32, device=device),
            torch.tensor(CLIP_STD, dtype=torch.float32, device=device))


def _normalize(pixels: torch.Tensor) -> torch.Tensor:
    mean, std = _clip_stats(pixels.device)
    return (pixels - mean) / std


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """[n_out, n_in] f32 weights of the 1-D bilinear resize with half-pixel
    centres and anti-aliasing: ``F.interpolate``'s filter, read off as the
    resize of the identity (each output row holds its input weights)."""
    eye = torch.eye(n_in, dtype=torch.float32, device=device)
    return F.interpolate(eye[None, None], size=(n_out, n_in), mode="bilinear",
                         align_corners=False, antialias=True)[0, 0].contiguous()


def _resize(pixels: torch.Tensor, size: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, size, size, C], bilinear with half-pixel centres
    and anti-aliasing (a triangle filter widened by the scale when it
    downsamples): the function ``jax.image.resize(..., "bilinear")``
    computes, and as it computes it, two contractions with the filter's
    weights (in f32, TF32 off). Its gradient is two products too, which
    sum in a fixed order (``F.interpolate``'s anti-aliased backward sums
    with atomics, so a PGD loop through it would not repeat bit for bit)."""
    h, w = pixels.shape[1:3]
    if h == size and w == size:
        return pixels
    with exact_f32():
        out = torch.einsum("oh,bhwc->bowc", _resize_weights(h, size, pixels.device), pixels)
        return torch.einsum("pw,bowc->bopc", _resize_weights(w, size, pixels.device), out)


def ensemble_loss(encoders: Sequence[SurrogateEncoder], x_pixels: torch.Tensor,
                  params_by_name, target_embeds) -> torch.Tensor:
    """Mean over the encoders of the mean cosine distance between the
    surrogate embeddings of ``x_pixels`` and ``target_embeds[name]``."""
    total = 0.0
    for enc in encoders:
        imgs = _normalize(_resize(x_pixels, enc.image_size))
        feats = enc.apply_fn(params_by_name[enc.name], imgs)
        total = total + torch.mean(1.0 - cosine_similarity(feats, target_embeds[enc.name]))
    return total / len(encoders)


class _PGDState(Captured):
    """The tensors a PGD step reads and updates: the adversarial pixels
    ``x`` (a leaf that takes the gradient, updated in place), the ball's
    bounds and the target embeddings; ``graph`` is the step captured on
    them."""

    def __init__(self, x_clean: torch.Tensor, epsilon: float, target_embeds):
        super().__init__()
        self.x = x_clean.clone().requires_grad_(True)
        self.lo = torch.clamp(x_clean - epsilon, 0.0, 1.0)
        self.hi = torch.clamp(x_clean + epsilon, 0.0, 1.0)
        self.targets = {k: v.detach().clone() for k, v in target_embeds.items()}

    def load(self, x_clean: torch.Tensor, epsilon: float, target_embeds) -> None:
        with torch.no_grad():
            self.x.copy_(x_clean)
            torch.clamp(x_clean - epsilon, 0.0, 1.0, out=self.lo)
            torch.clamp(x_clean + epsilon, 0.0, 1.0, out=self.hi)
            for k, v in target_embeds.items():
                self.targets[k].copy_(v)


def _pgd_step(encoders, params_by_name, st: _PGDState, step_size: float) -> None:
    """One sign step of the PGD loop, in place on ``st.x``: the gradient of
    the ensemble loss with respect to the pixels, then ``x - step_size *
    sign(grad)`` clamped into the ball."""
    loss = ensemble_loss(encoders, st.x, params_by_name, st.targets)
    (grad,) = torch.autograd.grad(loss, st.x)
    with torch.no_grad():
        st.x.copy_(torch.clamp(st.x - step_size * torch.sign(grad), st.lo, st.hi))


def make_pgd_attack(
    encoders: Sequence[SurrogateEncoder],
    epsilon: float = 8.0 / 255.0,
    step_size: float = 1.0 / 255.0,
    steps: int = 100,
):
    """Build the targeted PGD loop.

    Returns ``attack(params_by_name, x_clean_pixels [B,H,W,3] in [0,1],
    target_embeds: {name: [B, D]}, cuda_graph=True) -> x_adv_pixels``:
    ``steps`` sign steps of ``step_size``, each clipped to the ``epsilon``
    ball intersected with [0, 1]. Autograd is on inside the loop whatever
    the caller's mode. On the card the step (``_pgd_step``) is captured
    once for each (surrogate tensors, pixel shape, target shapes), at most
    two captures kept, sharing one memory pool, and replayed ``steps``
    times (``attack.captures`` counts the captures; a capture that fails
    raises); ``cuda_graph=False`` runs it eagerly there, as the CPU always
    does."""
    store = GraphStore(most=2)

    def attack(params_by_name, x_clean: torch.Tensor, target_embeds,
               cuda_graph: bool = True) -> torch.Tensor:
        x_clean = x_clean.detach()
        graphed = cuda_graph and x_clean.device.type == "cuda"
        if not graphed:
            st = _PGDState(x_clean, epsilon, target_embeds)
        else:
            key = (tree_addresses({enc.name: params_by_name[enc.name] for enc in encoders}),
                   tuple(x_clean.shape), x_clean.dtype, x_clean.device,
                   tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(target_embeds.items())))
            st = store.state(key, lambda: _PGDState(x_clean, epsilon, target_embeds))
            st.load(x_clean, epsilon, target_embeds)

        def step():
            _pgd_step(encoders, params_by_name, st, step_size)

        def restore():
            with torch.no_grad():
                st.x.copy_(x_clean)

        with exact_f32(), torch.enable_grad():
            if graphed and st.graph is None:
                # a real step (the warm-up), the pixels put back, the capture
                store.capture(st, step, restore, x_clean.device)
                attack.captures += 1
            for _ in range(steps):
                if graphed:
                    st.replay()
                else:
                    step()
        return st.x.detach().clone()

    attack.captures = 0
    return attack


def embed_images(encoders: Sequence[SurrogateEncoder], params_by_name,
                 pixels: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Surrogate embeddings of pixel images [B, H, W, 3] in [0, 1], per
    encoder name (no gradient)."""
    out = {}
    with exact_f32(), torch.no_grad():
        for enc in encoders:
            imgs = _normalize(_resize(pixels, enc.image_size))
            out[enc.name] = enc.apply_fn(params_by_name[enc.name], imgs)
    return out


def rgf_refine(
    victim_score: Callable[[np.ndarray], float],
    x_adv: np.ndarray,
    x_clean: np.ndarray,
    epsilon: float = 8.0 / 255.0,
    sigma: float = 8.0 / 255.0,
    step_size: float = 1.0 / 255.0,
    queries: int = 8,
    iters: int = 4,
    seed=0,  # anything np.random.default_rng accepts (int or int tuple)
) -> np.ndarray:
    """Query-based refinement with two-point RGF gradient estimates.

    ``victim_score(pixels) -> float`` is the black-box objective (e.g.
    CLIP-text similarity of the victim's caption to the target text);
    higher is better for the attacker. Stays within the l-inf ball
    around ``x_clean``.
    """
    rng = np.random.default_rng(seed)
    lo = np.clip(x_clean - epsilon, 0.0, 1.0)
    hi = np.clip(x_clean + epsilon, 0.0, 1.0)
    x = x_adv.copy()
    for _ in range(iters):
        base = victim_score(x)
        grad_est = np.zeros_like(x)
        for _ in range(queries):
            u = rng.standard_normal(x.shape).astype(np.float32)
            u /= np.linalg.norm(u) + 1e-12
            score = victim_score(np.clip(x + sigma * u, lo, hi))
            grad_est += (score - base) / sigma * u
        grad_est /= queries
        x = np.clip(x + step_size * np.sign(grad_est), lo, hi)
    return x


# ----------------------------------------------------------------------
# scoring & analysis
# ----------------------------------------------------------------------
def attack_success(clean_caption_sim: float, adv_caption_sim: float,
                   margin: float = 0.0) -> bool:
    """Success: the adversarial caption moved toward the target text."""
    return bool(adv_caption_sim > clean_caption_sim + margin)


def ancova(
    rows: Sequence[Dict[str, Any]],
    response: str = "similarity",
    covariate: str = "sigma",
    factor: str = "backbone",
    interaction: bool = True,
) -> Dict[str, Any]:
    """OLS ANCOVA: response ~ covariate + C(factor) [+ covariate:C(factor)].

    Returns coefficient estimates with t-statistics and p-values (numpy and
    scipy only).
    """
    y = np.asarray([float(r[response]) for r in rows])
    x_cov = np.asarray([float(r[covariate]) for r in rows])
    levels = sorted({r[factor] for r in rows})
    n = len(rows)

    cols: List[np.ndarray] = [np.ones(n), x_cov]
    names: List[str] = ["intercept", covariate]
    for lvl in levels[1:]:  # treatment coding, first level = baseline
        d = np.asarray([1.0 if r[factor] == lvl else 0.0 for r in rows])
        cols.append(d)
        names.append(f"{factor}[{lvl}]")
        if interaction:
            cols.append(d * x_cov)
            names.append(f"{covariate}:{factor}[{lvl}]")

    X = np.stack(cols, axis=1)
    beta, *_ = np.linalg.lstsq(X, y, rcond=None)
    resid = y - X @ beta
    dof = max(n - X.shape[1], 1)
    sigma2 = float(resid @ resid) / dof
    cov = sigma2 * np.linalg.pinv(X.T @ X)
    se = np.sqrt(np.maximum(np.diag(cov), 1e-30))
    t_vals = beta / se
    p_vals = 2.0 * sps.t.sf(np.abs(t_vals), dof)

    return {
        "coefficients": {
            name: {
                "estimate": float(b),
                "std_err": float(s),
                "t": float(t),
                "p_value": float(p),
            }
            for name, b, s, t, p in zip(names, beta, se, t_vals, p_vals)
        },
        "dof": dof,
        "r_squared": float(
            1.0 - (resid @ resid) / max(((y - y.mean()) ** 2).sum(), 1e-30)
        ),
    }
