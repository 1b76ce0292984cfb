"""Dataset builders.

A copy of ``certifiedgpt_tpu/data/builders.py``: a builder reads its
dataset block from the live config (``datasets.{name}``, through the
port's registry), instantiates the configured processors, and returns
``{split: dataset}``. Registered names: ``vqav2``, ``evalvqav2`` (the
certify and predict agents' dataset), ``testvqav2``, ``cc_sbu``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from certifiedgpt_tpu_torch.common.registry import registry
from certifiedgpt_tpu_torch.data.datasets import (
    CCSbuAlignDataset,
    VQAv2Dataset,
    VQAv2EvalDataset,
    VQAv2TestDataset,
)


def _as_list(value) -> List[str]:
    if value is None:
        return []
    if isinstance(value, str):
        return [value]
    return list(value)


class BaseDatasetBuilder:
    dataset_cls = None
    splits = ("train",)

    def __init__(self, cfg: Optional[dict] = None):
        if cfg is None:
            config = registry.get("configuration")
            cfg = config.datasets.get(self.name, {}) if config is not None else {}
        self.cfg = cfg

    def _processor(self, kind: str, split: str):
        block = self.cfg.get(f"{kind}_processor", {}) or {}
        proc_cfg = block.get(split) or block.get("train")
        if proc_cfg is None:
            return None
        name = proc_cfg.get("name")
        proc_cls = registry.get_processor_class(name)
        if proc_cls is None:
            raise KeyError(f"Unknown processor '{name}' for {self.name}.{split}")
        return proc_cls.from_config(proc_cfg)

    def build_datasets(self) -> Dict[str, Any]:
        build_info = self.cfg.get("build_info", {})
        images = build_info.get("images", {})
        questions = build_info.get("questions", {})
        annotations = build_info.get("annotations", {})
        datasets = {}
        for split in self.splits:
            ann_paths = _as_list(annotations.get(split))
            q_paths = _as_list(questions.get(split))
            if not ann_paths and not q_paths:
                continue
            datasets[split] = self.dataset_cls(
                vis_processor=self._processor("vis", split),
                text_processor=self._processor("text", split),
                questions_paths=q_paths,
                vis_paths=images.get("storage") or images.get(split),
                annotation_paths=ann_paths,
                split=split,
            )
        return datasets


@registry.register_builder("vqav2")
class VQAv2Builder(BaseDatasetBuilder):
    name = "vqav2"
    dataset_cls = VQAv2Dataset
    splits = ("train", "val")


@registry.register_builder("evalvqav2")
class VQAv2EvalBuilder(BaseDatasetBuilder):
    name = "evalvqav2"
    dataset_cls = VQAv2EvalDataset
    splits = ("val",)


@registry.register_builder("testvqav2")
class VQAv2TestBuilder(BaseDatasetBuilder):
    name = "testvqav2"
    dataset_cls = VQAv2TestDataset
    splits = ("test",)


@registry.register_builder("cc_sbu")
class CCSbuBuilder(BaseDatasetBuilder):
    name = "cc_sbu"
    dataset_cls = CCSbuAlignDataset
    splits = ("train",)

    def build_datasets(self) -> Dict[str, Any]:
        build_info = self.cfg.get("build_info", {})
        images = build_info.get("images", {})
        annotations = build_info.get("annotations", {})
        datasets = {}
        for split in self.splits:
            ann_paths = _as_list(annotations.get(split))
            if not ann_paths:
                continue
            datasets[split] = self.dataset_cls(
                vis_processor=self._processor("vis", split),
                text_processor=self._processor("text", split),
                vis_paths=images.get("storage") or images.get(split),
                annotation_paths=ann_paths,
                split=split,
                prompt_path=build_info.get("prompt_path"),
                prompt_template=build_info.get("prompt_template", "{}"),
            )
        return datasets
