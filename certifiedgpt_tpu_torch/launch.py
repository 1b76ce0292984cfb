"""Launcher CLI of the PyTorch port.

The counterpart of the repository's ``launch.py`` for the port::

    python -m certifiedgpt_tpu_torch.launch {train,certify,smoothing_predict,eval,attack} \\
        --config-path cfg.yaml [--device cuda|cpu]

The mode picks the agent unless the config's ``run.agent`` names one
(``MODE_DEFAULT_AGENTS``, as in the JAX launcher); the logger writes to the
console and ``{run.output_dir}/certified.log``; Python's and numpy's global
seeds are set from ``run.seed``. The model runs on ``--device``, the card by
default: without CUDA, ``--device cuda`` stops with an error and nothing
falls back to the CPU.

``run.distributed`` joins a ``torch.distributed`` process group from the
``env://`` variables that ``torch.distributed.run`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL on
``--device cuda`` with this process on ``cuda:{LOCAL_RANK}``, gloo on
``--device cpu``, one process per rank of the agent's mesh
(``run.model_parallel``, ``run.dcn_parallel``)::

    python -m torch.distributed.run --nproc_per_node N -m certifiedgpt_tpu_torch.launch \
        certify --config-path cfg.yaml

A group that the caller already initialized is used as it is. The group
this launcher made is destroyed when the run ends. Unlike the JAX launcher,
which goes on as a single process when ``jax.distributed.initialize``
fails, a failed join raises: no fallback hides a broken cluster.
"""

from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np
import torch

from certifiedgpt_tpu_torch import registration  # noqa: F401 (component registration)
from certifiedgpt_tpu_torch.agents.base import setup_agent
from certifiedgpt_tpu_torch.common.config import Config
from certifiedgpt_tpu_torch.common.logging import setup_logger
from certifiedgpt_tpu_torch.common.registry import registry
from certifiedgpt_tpu_torch.parallel.mesh import set_active_mesh

MODE_DEFAULT_AGENTS = {
    "train": "image_text_finetune",
    "eval": "image_text_eval",
    "smoothing_predict": "image_text_predict",
    "certify": "image_text_certify",
    "attack": "image_text_attack",
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="certifiedgpt_tpu_torch launcher")
    parser.add_argument("mode", choices=sorted(MODE_DEFAULT_AGENTS.keys()), help="run mode")
    parser.add_argument("--config-path", required=True, help="YAML config path")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device the model runs on (default: cuda)")
    return parser.parse_args(argv)


def setup_seeds(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)


def init_distributed(device: str):
    """Join the process group of ``torch.distributed.run``'s environment;
    returns (the device this rank runs on, whether this call made the
    group)."""
    import torch.distributed as dist

    if dist.is_initialized():
        rank = dist.get_rank()
        made = False
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"run.distributed: the env:// variables {missing} are not set; launch "
                "with python -m torch.distributed.run --nproc_per_node N -m "
                "certifiedgpt_tpu_torch.launch ..."
            )
        dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method="env://")
        rank = dist.get_rank()
        made = True
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
        return f"cuda:{local}", made
    return device, made


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "certifiedgpt_tpu_torch.launch: --device cuda, but no CUDA device is "
            "available (torch.cuda.is_available() is False); pass --device cpu to run "
            "on the CPU"
        )
    config = Config(args.config_path)

    run = config.run
    # mode picks the agent unless the config explicitly names one
    if not run.get("agent"):
        # an explicitly empty "run:" block loads as None: normalize
        if config.config._data.get("run") is None:
            config.config._data["run"] = {}
        config.config._data["run"]["agent"] = MODE_DEFAULT_AGENTS[args.mode]
    logger = setup_logger(str(run.get("output_dir", "output")))
    setup_seeds(int(run.get("seed", 42)))
    registry.register("mode", args.mode)
    device, made_group = args.device, False
    if run.get("distributed", False):
        import torch.distributed as dist

        device, made_group = init_distributed(args.device)
        logger.info("torch.distributed: rank %d of %d (%s) on %s", dist.get_rank(),
                    dist.get_world_size(), dist.get_backend(), device)
    try:
        logger.info("mode=%s agent=%s device=%s", args.mode, config.run.get("agent"), device)
        agent = setup_agent(config, device=device)
        try:
            result = agent.run()
            logger.info("run complete: %s", result)
            return result
        finally:
            agent.finalize()
    finally:
        if made_group:
            import torch.distributed as dist

            set_active_mesh(None)
            dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
