"""Launcher CLI of the PyTorch port.

The counterpart of the repository's ``launch.py`` for the port::

    python -m certifiedgpt_tpu_torch.launch {train,certify,smoothing_predict,eval,attack} \\
        --config-path cfg.yaml [--device cuda|cpu]

The mode picks the agent unless the config's ``run.agent`` names one
(``MODE_DEFAULT_AGENTS``, as in the JAX launcher); the logger writes to the
console and ``{run.output_dir}/certified.log``; Python's and numpy's global
seeds are set from ``run.seed``. The model runs on ``--device``, the card by
default: without CUDA, ``--device cuda`` stops with an error and nothing
falls back to the CPU. ``run.distributed`` raises ``NotImplementedError``
until multi-process runs are ported.
"""

from __future__ import annotations

import argparse
import random
import sys

import numpy as np
import torch

from certifiedgpt_tpu_torch import registration  # noqa: F401 (component registration)
from certifiedgpt_tpu_torch.agents.base import setup_agent
from certifiedgpt_tpu_torch.common.config import Config
from certifiedgpt_tpu_torch.common.logging import setup_logger
from certifiedgpt_tpu_torch.common.registry import registry

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
    if run.get("distributed", False):
        raise NotImplementedError(
            "run.distributed: multi-process runs are not ported yet "
            "(ROADMAP.md, modules item 16)"
        )

    logger = setup_logger(str(run.get("output_dir", "output")))
    setup_seeds(int(run.get("seed", 42)))
    registry.register("mode", args.mode)
    logger.info("mode=%s agent=%s device=%s", args.mode, config.run.get("agent"), args.device)
    agent = setup_agent(config, device=args.device)
    try:
        result = agent.run()
        logger.info("run complete: %s", result)
        return result
    finally:
        agent.finalize()


if __name__ == "__main__":
    main(sys.argv[1:])
