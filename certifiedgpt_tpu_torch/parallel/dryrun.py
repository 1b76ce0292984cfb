"""The multi-process dry run: the port's counterpart of
``__graft_entry__.py::dryrun_multichip``.

``dryrun_multichip(n)`` starts ``n`` gloo CPU processes
(``parallel/processes.py``) and runs, on the tiny model with seeded
parameters, the five cases of the JAX dry run:

1. one train step on a data x model mesh (model = 2 when ``n`` is even and
   at least 4): the decoder tensor-parallel, the batch split over data;
2. a packed train step (3 samples a row, one packed row a data rank) on the
   same mesh, from the parameters after step 1;
3. a certification (``Smooth.predict``) with the Monte-Carlo batch split
   over data and the decoder over model, on those parameters;
4. a train step and a certification on a dcn=2 x data=n/2 mesh from the
   seeded parameters;
5. the loss and the ``llama_proj`` gradient of the train batch (no noise)
   through the GPipe decoder (``parallel/pipeline.py``) on a pipe=2 x
   data=n/2 mesh at 2 microbatches, from the seeded parameters.

The image noise of the train steps is drawn on the host from numpy seeds
(``dryrun_inputs``), so that the JAX package can run the same cases on the
same parameters, batches and noise; the certification's noise is the
port's own (``smoothing/classifier.py``). ``dryrun_cases(n,
distributed=False)`` runs the cases in one process, the reference each
rank's results equal.
"""

from __future__ import annotations

import json
import math
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from certifiedgpt_tpu_torch.parallel.mesh import (
    ProcessMesh,
    make_mesh,
    set_active_mesh,
    shard_decoder,
)
from certifiedgpt_tpu_torch.parallel.pipeline import stage_decoder

#: the certification prompt and answer set of the JAX dry run
PROMPT = "<Img><ImageHere></Img> [vqa] what?"
ANSWERS = ("cat", "dog")
#: the microbatches of the pipeline case, as the JAX dry run's
PIPE_MICRO = 2
_RESULT_FILE = "dryrun_result.json"


def grid(n_devices: int):
    """(n_data, n_model) of the dp x tp mesh, as the JAX dry run picks it."""
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    return n_devices // n_model, n_model


def _train_text(tok, cfg, batch: int, seq: int):
    from certifiedgpt_tpu_torch.data.text import BatchSpec, build_train_batch

    spec = BatchSpec(seq_len=seq, num_img_tokens=cfg.num_img_tokens, max_answer_len=8)
    instructions = [f"<Img><ImageHere></Img> [vqa] what is object {i}?" for i in range(batch)]
    answers = ["cat" if i % 2 == 0 else "dog" for i in range(batch)]
    return build_train_batch(tok, instructions, answers, spec)


def _packed_text(tok, cfg, batch: int):
    from certifiedgpt_tpu_torch.data.text import BatchSpec, pack_train_batch

    spec = BatchSpec(seq_len=135, num_img_tokens=cfg.num_img_tokens, max_answer_len=8)
    return pack_train_batch(
        tok, [f"<Img><ImageHere></Img> [vqa] object {i}?" for i in range(batch)],
        ["cat" if i % 2 == 0 else "dog" for i in range(batch)], spec, 3)


def dryrun_inputs(n_devices: int) -> Dict[str, Any]:
    """The seeded inputs of the dry run, as numpy: the tiny model's float
    parameters (seed 0), the train batch (``n_data * 2`` rows, 48 tokens)
    and its noise (sigma 0.5), the packed batch (``n_data * 3`` samples)
    and its noise."""
    from certifiedgpt_tpu_torch.data.text import ByteTokenizer
    from certifiedgpt_tpu_torch.models.minigpt4 import MiniGPT4Config
    from certifiedgpt_tpu_torch.models.model_zoo import build_synthetic_params

    cfg = MiniGPT4Config.tiny()
    n_data, _ = grid(n_devices)
    tok = ByteTokenizer()
    params = build_synthetic_params(cfg, "cpu", seed=0, quantize_vit=False,
                                    quantize_llama=False)
    img = (cfg.vit.img_size, cfg.vit.img_size, 3)
    b, bp = n_data * 2, n_data * 3
    batch = dict(_train_text(tok, cfg, b, 48),
                 image=np.random.RandomState(0).randn(b, *img).astype(np.float32))
    packed = dict(_packed_text(tok, cfg, bp),
                  image=np.random.RandomState(3).randn(bp, *img).astype(np.float32))
    return {
        "cfg": cfg,
        "params": _to_numpy(params),
        "batch": batch,
        "noise": (0.5 * np.random.RandomState(1).randn(b, *img)).astype(np.float32),
        "packed": packed,
        "packed_noise": (0.5 * np.random.RandomState(4).randn(bp, *img)).astype(np.float32),
    }


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


class _Run:
    """The tiny model of one case on one mesh (None: one process), with
    ``llama_proj`` trainable and AdamW at lr 1e-4, as the JAX dry run's
    ``make_optimizer(lambda step: 1e-4)``."""

    def __init__(self, cfg, params, mesh: Optional[ProcessMesh]):
        from certifiedgpt_tpu_torch.data.text import ByteTokenizer
        from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model
        from certifiedgpt_tpu_torch.optim import AdamW

        set_active_mesh(mesh)
        self.mesh, self.cfg = mesh, cfg
        self.model = MiniGPT4Model(cfg, _to_torch(params), ByteTokenizer())
        if mesh is not None and mesh.n_model > 1:
            shard_decoder(self.model, mesh)
        if mesh is not None and mesh.n_pipe > 1:
            stage_decoder(self.model, mesh)
        self.trainable = self.model.make_trainable(("llama_proj",))
        self.optimizer = AdamW(self.trainable, lambda step: 1e-4)

    def rows(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t if self.mesh is None else self.mesh.local_rows(t)

    def _rows_batch(self, batch: Dict[str, np.ndarray], noise: Optional[np.ndarray]):
        dev = {k: self.rows(v).long() for k, v in batch.items() if k != "image"}
        dev["image"] = self.rows(batch["image"])
        if noise is not None:
            dev["image"] = dev["image"] + self.rows(noise)
        return dev

    def train_step(self, batch: Dict[str, np.ndarray], noise: np.ndarray) -> float:
        """One step on the noisy batch; returns its loss (before the
        update), the finetune agent's data-parallel step."""
        from certifiedgpt_tpu_torch.agents.finetune import data_parallel_step

        return float(data_parallel_step(self.model, self._rows_batch(batch, noise),
                                        self.optimizer, self.mesh))

    def loss_and_grad_norm(self, batch: Dict[str, np.ndarray], n_micro: int):
        """The loss of the batch (no noise) and the global norm of its
        ``llama_proj`` gradient, the decoder pipelined over the mesh's
        stages at ``n_micro`` microbatches (one process: the sequential
        decoder)."""
        from certifiedgpt_tpu_torch.agents.finetune import data_parallel_loss

        loss = data_parallel_loss(self.model, self._rows_batch(batch, None),
                                  self.optimizer.params, self.mesh, n_micro)
        norm = math.sqrt(sum(float((p.grad.double() ** 2).sum())
                             for p in self.optimizer.params))
        return float(loss), norm

    @torch.no_grad()
    def certify(self, mc_batch: int) -> int:
        from certifiedgpt_tpu_torch.smoothing.classifier import AnswerVocabulary, make_sample_fn
        from certifiedgpt_tpu_torch.smoothing.smoothing import Smooth

        vocab = AnswerVocabulary(list(ANSWERS))
        sample_fn = make_sample_fn(self.model, PROMPT, vocab, sigma=0.5, mc_batch=mc_batch,
                                   max_new_tokens=3, seq_len=32, mesh=self.mesh)
        image = np.zeros((self.cfg.vit.img_size, self.cfg.vit.img_size, 3), np.float32)
        return int(Smooth(sample_fn, vocab.num_classes, sigma=0.5).predict(
            image, n=mc_batch, alpha=0.5, seed=0))


def dryrun_cases(n_devices: int, distributed: bool) -> Dict[str, Any]:
    """The five cases' losses and labels: on this process's rank of
    ``n_devices`` gloo ranks when ``distributed``, else in one process."""
    inputs = dryrun_inputs(n_devices)
    cfg = inputs["cfg"]
    n_data, n_model = grid(n_devices)
    out: Dict[str, Any] = {"n_data": n_data, "n_model": n_model}
    try:
        run = _Run(cfg, inputs["params"],
                   make_mesh(n_data=n_data, n_model=n_model) if distributed else None)
        out["loss"] = run.train_step(inputs["batch"], inputs["noise"])
        out["packed_loss"] = run.train_step(inputs["packed"], inputs["packed_noise"])
        out["certify_label"] = run.certify(n_data * 2)
        if n_devices >= 4 and n_devices % 2 == 0:
            mesh = make_mesh(n_model=1, n_dcn=2) if distributed else None
            run = _Run(cfg, inputs["params"], mesh)
            out["dcn_loss"] = run.train_step(inputs["batch"], inputs["noise"])
            out["dcn_certify_label"] = run.certify(n_devices)
            out["dcn_data"] = n_devices // 2
            mesh = make_mesh(n_pipe=2) if distributed else None
            run = _Run(cfg, inputs["params"], mesh)
            out["pipe_loss"], out["pipe_grad_norm"] = run.loss_and_grad_norm(inputs["batch"],
                                                                             PIPE_MICRO)
            out["pipe_data"] = n_devices // 2
    finally:
        set_active_mesh(None)
    return out


def summary_line(n_devices: int, res: Dict[str, Any]) -> str:
    """The result in the JAX dry run's form."""
    line = (f"dryrun_multichip ok: {n_devices} processes (data={res['n_data']} x "
            f"model={res['n_model']}), loss={res['loss']:.4f}, packed-train "
            f"loss={res['packed_loss']:.4f}, sharded-certify label={res['certify_label']}")
    if "dcn_certify_label" in res:
        line += (f", dcn-train loss={res['dcn_loss']:.4f}, dcn-certify "
                 f"label={res['dcn_certify_label']} (dcn=2 x data={res['dcn_data']})")
    if "pipe_loss" in res:
        line += f", pipeline-train loss={res['pipe_loss']:.4f} (pipe=2 x data={res['pipe_data']})"
    return line


_WORKER = f"""
import json
from certifiedgpt_tpu_torch.parallel.dryrun import dryrun_cases
res = dryrun_cases(WORLD_SIZE, distributed=True)
if RANK == 0:
    with open({_RESULT_FILE!r}, "w") as handle:
        json.dump(res, handle)
"""


def dryrun_multichip(n_devices: int, workdir: Optional[str] = None,
                     timeout: float = 600.0) -> Dict[str, Any]:
    """Run the cases on ``n_devices`` gloo CPU processes; prints the
    summary line and returns rank 0's results."""
    from certifiedgpt_tpu_torch.parallel.processes import run_ranks

    with tempfile.TemporaryDirectory(prefix="dryrun_", dir=workdir) as tmp:
        run_ranks(n_devices, _WORKER, tmp, timeout=timeout)
        with open(os.path.join(tmp, _RESULT_FILE)) as handle:
            res = json.load(handle)
    print(summary_line(n_devices, res), flush=True)
    return res


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
