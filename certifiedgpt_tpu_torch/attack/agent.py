"""Attack-evaluation agent (``image_text_attack``).

Port of ``certifiedgpt_tpu/attack/agent.py``. For each image of the
dataset: take the next image as the target, craft an adversarial image
against each CLIP surrogate (the PGD transfer stage, once per backbone and
reused across the sigma grid), then for each victim-side sigma caption the
clean image once and, per backbone, run the optional RGF query stage
against the smoothed victim and caption the adversarial image; score each
caption by text-embedding similarity to the target text. Writes
``attack_results.jsonl``, ``attack_summary.json`` (per-backbone success
rates, ``success_rate_grid`` over a ``sigma_grid``, the ``ancova``) and
``attack_ancova.csv``, with the JAX agent's keys.

Run-block knobs: ``attack_backbones`` (rn50/rn101/blip2_vit/vit_b16/
vit_b32/vit_l14; tiny variants for tests), ``attack_epsilon``,
``attack_steps``, ``attack_step_size``, ``rgf_queries``, ``rgf_iters``,
``max_images``, ``noise_level`` / ``sigma_grid`` (victim-side smoothing),
``clip_model`` and ``clip_model_<backbone>`` (an HF CLIP directory for a
ViT surrogate and the text scorer; an OpenAI ``visual.*`` checkpoint for
RN50/RN101). ``blip2_vit`` reads the model block's ``eva_vit_g_pth``.

Weights are read with the port's own readers: an HF directory's
``*.safetensors`` (``models/safetensors_io.py``) or ``pytorch_model.bin``
(``torch.load``) and its ``config.json`` (CLIP's defaults for the fields it
leaves out); an OpenAI ``.pt``, a plain state dict or a TorchScript archive;
``eva_vit_g.pth`` through ``models/convert.py``. A surrogate without weights
runs on seeded ones and warns; without a CLIP directory the captions are
scored by a bag-of-words hash encoder, which warns too. The text tokenizer
is ``transformers``' (``AutoTokenizer``), the one dependency beside torch.

The victim is the agent's MiniGPT-4 (``model.vqa_finetuned`` replaces its
projection). Each caption normalizes the pixels with the dataset
processor's mean/std, resizes them to ``vit.img_size``, adds ``sigma *
N(0, 1)`` drawn from a generator seeded by ``caption_key(seed, stream,
sigma)`` and runs the greedy decode at batch 1, without autograd. The
streams cannot equal the JAX package's ``jax.random`` draws; rows agree
with the JAX agent's at sigma 0.
"""

from __future__ import annotations

import csv
import glob
import json
import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from certifiedgpt_tpu_torch.agents.base import BaseAgent
from certifiedgpt_tpu_torch.attack.attack import (
    SurrogateEncoder,
    _resize,
    ancova,
    attack_success,
    embed_images,
    exact_f32,
    make_pgd_attack,
    rgf_refine,
)
from certifiedgpt_tpu_torch.attack.clip import (
    ClipResNetConfig,
    ClipTextConfig,
    ClipViTConfig,
    clip_resnet_image,
    clip_text,
    clip_vit_image,
    convert_hf_clip,
    convert_openai_clip_resnet,
    init_clip_resnet,
    init_clip_vit,
)
from certifiedgpt_tpu_torch.common.registry import registry
from certifiedgpt_tpu_torch.data.processors import CLIP_MEAN, CLIP_STD
from certifiedgpt_tpu_torch.data.text import (
    BatchSpec,
    build_gen_batch,
    clean_answer,
    decode_until_eos,
)
from certifiedgpt_tpu_torch.models.convert import convert_eva_vit_state_dict
from certifiedgpt_tpu_torch.models.eva_vit import EvaViTConfig, eva_vit_apply
from certifiedgpt_tpu_torch.models.minigpt4 import generate_greedy
from certifiedgpt_tpu_torch.models.model_zoo import _Init, _torch_load, _vit_params
from certifiedgpt_tpu_torch.models.safetensors_io import SafetensorsDir
from certifiedgpt_tpu_torch.smoothing.classifier import chunk_seed


def caption_key(seed: int, stream: Sequence[int], sigma: float) -> int:
    """Generator seed of one victim caption draw.

    ``stream`` is a tuple of ints naming the caller's draw: ``(0, image)``
    clean, ``(1, image, backbone)`` adversarial score, ``(2, image,
    sigma_idx, backbone, query)`` RGF query. Each part, then sigma's f32
    bit pattern, is chained through the splitmix64 ``chunk_seed``, as the
    JAX package chains ``fold_in``: every caller's stream and every sigma
    row of a grid draw apart (an arithmetic packing such as
    ``tag*1000+step`` collides once the RGF budget crosses its base)."""
    h = int(seed)
    for part in stream:
        h = chunk_seed(h, int(part))
    return chunk_seed(h, int(np.float32(sigma).view(np.uint32)) & 0x7FFFFFFF)


# ----------------------------------------------------------------------
# surrogate backbones: name -> (config, apply_fn(params, cfg, images),
# init_fn(seed, cfg, device))
# ----------------------------------------------------------------------
_BACKBONES: Dict[str, Callable[[], Tuple[Any, Any, Any]]] = {}


def _register_backbone(name):
    def wrap(fn):
        _BACKBONES[name] = fn
        return fn

    return wrap


@_register_backbone("vit_b32")
def _vit_b32():
    return ClipViTConfig.b32(), clip_vit_image, init_clip_vit


@_register_backbone("vit_b16")
def _vit_b16():
    return ClipViTConfig.b16(), clip_vit_image, init_clip_vit


@_register_backbone("vit_l14")
def _vit_l14():
    return ClipViTConfig.l14(), clip_vit_image, init_clip_vit


@_register_backbone("rn50")
def _rn50():
    return ClipResNetConfig.rn50(), clip_resnet_image, init_clip_resnet


@_register_backbone("rn101")
def _rn101():
    return ClipResNetConfig.rn101(), clip_resnet_image, init_clip_resnet


def eva_feature(params, cfg: EvaViTConfig, images: torch.Tensor) -> torch.Tensor:
    """The BLIP surrogate's feature: EVA ViT's cls token."""
    return eva_vit_apply(params, cfg, images)[:, 0]


def init_eva_surrogate(seed: int, cfg: EvaViTConfig, device="cpu") -> Dict[str, Any]:
    """Seeded float EVA ViT weights (no int8 kernels)."""
    return _vit_params(_Init(seed, device), cfg, quantize=False)


@_register_backbone("blip2_vit")
def _blip2_vit():
    """BLIP-family surrogate: BLIP-2's vision tower is EVA ViT-g; f32 on the
    plain attention block (never the split-stream kernels, which have no
    backward)."""
    return (EvaViTConfig(img_size=224, dtype=torch.float32, attn_impl="xla"),
            eva_feature, init_eva_surrogate)


@_register_backbone("blip2_vit_tiny")
def _blip2_vit_tiny():
    return EvaViTConfig.tiny(), eva_feature, init_eva_surrogate


@_register_backbone("vit_tiny")
def _vit_tiny():
    return ClipViTConfig.tiny(), clip_vit_image, init_clip_vit


@_register_backbone("rn_tiny")
def _rn_tiny():
    return ClipResNetConfig.tiny(), clip_resnet_image, init_clip_resnet


# ----------------------------------------------------------------------
# readers
# ----------------------------------------------------------------------
def read_hf_state_dict(path: str) -> Mapping[str, torch.Tensor]:
    """The state dict of an HF model directory: its ``*.safetensors``
    (read lazily; the caller closes it) or ``pytorch_model.bin``."""
    if glob.glob(os.path.join(path, "*.safetensors")):
        return SafetensorsDir(path)
    return _torch_load(os.path.join(path, "pytorch_model.bin"))


def convert_hf_dir(path: str, vit_cfg: ClipViTConfig, text_cfg: ClipTextConfig,
                   device) -> Dict[str, Dict[str, Any]]:
    """``convert_hf_clip`` of an HF CLIP directory's state dict."""
    sd = read_hf_state_dict(path)
    try:
        return convert_hf_clip(sd, vit_cfg, text_cfg, device)
    finally:
        if isinstance(sd, SafetensorsDir):
            sd.close()


def hf_text_config(path: str) -> ClipTextConfig:
    """The text tower's config from an HF CLIP directory's ``config.json``,
    with ``CLIPTextConfig``'s defaults (ClipTextConfig's) for the fields it
    leaves out."""
    with open(os.path.join(path, "config.json")) as handle:
        conf = json.load(handle)
    text = conf.get("text_config") or {}
    base = ClipTextConfig()
    return ClipTextConfig(
        vocab_size=int(text.get("vocab_size", base.vocab_size)),
        max_len=int(text.get("max_position_embeddings", base.max_len)),
        hidden_size=int(text.get("hidden_size", base.hidden_size)),
        num_layers=int(text.get("num_hidden_layers", base.num_layers)),
        num_heads=int(text.get("num_attention_heads", base.num_heads)),
        intermediate_size=int(text.get("intermediate_size", base.intermediate_size)),
        projection_dim=int(conf.get("projection_dim", base.projection_dim)),
    )


def load_openai_state_dict(path: str) -> Mapping[str, torch.Tensor]:
    """An OpenAI CLIP checkpoint's state dict: a plain ``torch.save`` dict,
    or a TorchScript archive (the released ``RN50.pt``/``RN101.pt``)."""
    try:
        sd = _torch_load(path)
    except RuntimeError as exc:
        if "TorchScript" not in str(exc):
            raise
        sd = torch.jit.load(path, map_location="cpu")
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def _tree_shapes(tree, path=()) -> List[Tuple[tuple, Any]]:
    if isinstance(tree, Mapping):
        return [e for key in sorted(tree) for e in _tree_shapes(tree[key], path + (key,))]
    if isinstance(tree, (list, tuple)):
        return [e for i, sub in enumerate(tree) for e in _tree_shapes(sub, path + (i,))]
    shape = getattr(tree, "shape", None)
    return [(path, None if shape is None else tuple(shape))]


class _HashTextEncoder:
    """Dependency-free stand-in text scorer: bag-of-words hash embedding.

    Used when no pretrained CLIP text tower/tokenizer is configured
    (random-weight runs, tests). Real runs configure ``clip_model`` and
    get the true CLIP text encoder.
    """

    def __init__(self, dim: int = 64):
        self.dim = dim

    def _bucket(self, word: str) -> int:
        import hashlib

        # hashlib, not hash(): Python's str hash is per-process salted and
        # would make attack scores irreproducible across runs
        digest = hashlib.md5(word.encode("utf-8")).digest()
        return int.from_bytes(digest[:4], "little") % self.dim

    def __call__(self, texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, text in enumerate(texts):
            for word in text.lower().split():
                out[i, self._bucket(word)] += 1.0
        norm = np.linalg.norm(out, axis=-1, keepdims=True)
        return out / np.maximum(norm, 1e-8)


@registry.register_agent("image_text_attack")
class AttackAgent(BaseAgent):
    def __init__(self, config, device="cuda"):
        super().__init__(config, device)
        run = self.run_cfg
        self.backbone_names = list(run.get("attack_backbones", ["vit_b32", "vit_b16", "rn50"]))
        self.epsilon = float(run.get("attack_epsilon", 8.0 / 255.0))
        self.steps = int(run.get("attack_steps", 100))
        self.step_size = float(run.get("attack_step_size", 1.0 / 255.0))
        self.rgf_queries = int(run.get("rgf_queries", 0))
        self.rgf_iters = int(run.get("rgf_iters", 4))
        self.max_images = run.get("max_images")
        self.noise_level = float(run.get("noise_level", 0.0))
        self.max_new_tokens = int(run.get("max_new_tokens", 10))
        self.seq_len = int(run.get("seq_len", 96))
        self.seed = int(run.get("seed", 42))

        finetuned = self.load_finetuned({"llama_proj": self.model.params["llama_proj"]})
        if finetuned is not None:
            self.model.set_llama_proj(finetuned["llama_proj"])

        self.encoders = self._build_encoders()
        self.text_encoder = self._build_text_encoder()
        self._victim_generate = self._build_victim()

    # ------------------------------------------------------------------
    @staticmethod
    def _shapes_match(template, converted) -> bool:
        """Same tree structure and leaf shapes: guards against loading a
        same-depth, different-patch CLIP variant whose converter happens to
        succeed (e.g. a ViT-B/32 directory into the vit_b16 config)."""
        return _tree_shapes(template) == _tree_shapes(converted)

    def _build_encoders(self) -> List[SurrogateEncoder]:
        encoders = []
        for i, name in enumerate(self.backbone_names):
            if name not in _BACKBONES:
                raise KeyError(f"Unknown attack backbone '{name}'")
            cfg, apply_fn, init_fn = _BACKBONES[name]()
            params = init_fn(1000 + i, cfg, self.device)
            loaded = False
            # per-backbone dir first (clip_model_vit_b16: one HF dir per
            # variant), then the shared clip_model, with a shape check
            clip_dir = self.run_cfg.get(f"clip_model_{name}", self.run_cfg.get("clip_model"))
            if clip_dir and name.startswith("vit") and os.path.exists(str(clip_dir)):
                try:
                    converted = convert_hf_dir(str(clip_dir), cfg, ClipTextConfig(),
                                               self.device)["vision"]
                    if self._shapes_match(params, converted):
                        params = converted
                        loaded = True
                        self.logger.info("Loaded %s weights from %s", name, clip_dir)
                    else:
                        self.logger.warning(
                            "clip dir %s does not match backbone %s (wrong CLIP variant?); "
                            "random init — set run.clip_model_%s to the matching HF dir",
                            clip_dir, name, name,
                        )
                except Exception as exc:  # a bad directory keeps the random init
                    self.logger.warning("CLIP load failed for %s (%s); random init", name, exc)
            rn_ckpt = self.run_cfg.get(f"clip_model_{name}")
            if name.startswith("rn") and rn_ckpt and os.path.exists(str(rn_ckpt)):
                # OpenAI ``visual.*`` ResNet checkpoint
                try:
                    converted = convert_openai_clip_resnet(
                        load_openai_state_dict(str(rn_ckpt)), cfg, self.device)
                    if self._shapes_match(params, converted):
                        params = converted
                        loaded = True
                        self.logger.info("Loaded %s weights from %s", name, rn_ckpt)
                    else:
                        self.logger.warning("checkpoint %s does not match backbone %s; "
                                            "random init", rn_ckpt, name)
                except Exception as exc:  # a bad checkpoint keeps the random init
                    self.logger.warning("CLIP ResNet load failed for %s (%s); random init",
                                        name, exc)

            if name.startswith("blip2"):
                # BLIP surrogate weights: the reference's eva_vit_g.pth (the
                # position table is resampled to the surrogate resolution)
                vit_path = self.config.model.get("eva_vit_g_pth")
                if vit_path and os.path.exists(str(vit_path)):
                    try:
                        converted = convert_eva_vit_state_dict(
                            _torch_load(str(vit_path)), cfg, self.device)
                        if self._shapes_match(params, converted):
                            params = converted
                            loaded = True
                            self.logger.info("Loaded %s weights from %s", name, vit_path)
                        else:
                            self.logger.warning(
                                "eva checkpoint %s does not match surrogate %s config; "
                                "random init", vit_path, name,
                            )
                    except Exception as exc:  # a bad checkpoint keeps the random init
                        self.logger.warning("EVA load failed for %s (%s); random init",
                                            name, exc)

            if not loaded and not name.endswith("_tiny"):
                # a full-scale surrogate on random features: its success rate
                # and ANCOVA rows would look like the reference's result while
                # measuring noise
                self.logger.warning(
                    "attack backbone %s is running on RANDOM weights; its success rate is "
                    "meaningless (set run.clip_model / run.clip_model_%s)", name, name,
                )

            def make_apply(fn, c):
                return lambda p, imgs: fn(p, c, imgs)

            encoders.append(SurrogateEncoder(
                name=name, apply_fn=make_apply(apply_fn, cfg), params=params,
                image_size=getattr(cfg, "image_size", None) or getattr(cfg, "img_size"),
            ))
        return encoders

    def _build_text_encoder(self):
        """The CLIP text tower and tokenizer when ``clip_model`` names an HF
        CLIP directory; the bag-of-words hash stand-in otherwise."""
        clip_dir = self.run_cfg.get("clip_model")
        if clip_dir and os.path.exists(str(clip_dir)):
            try:
                from transformers import AutoTokenizer

                tcfg = hf_text_config(str(clip_dir))
                tok = AutoTokenizer.from_pretrained(str(clip_dir))
                text_params = convert_hf_dir(str(clip_dir), ClipViTConfig.tiny(), tcfg,
                                             self.device)["text"]
                device = self.device

                def encode(texts):
                    batch = tok(texts, padding="max_length", truncation=True,
                                max_length=tcfg.max_len, return_tensors="np")
                    ids = torch.from_numpy(np.asarray(batch["input_ids"])).long().to(device)
                    with exact_f32(), torch.no_grad():
                        embs = clip_text(text_params, tcfg, ids).cpu().numpy()
                    norm = np.linalg.norm(embs, axis=-1, keepdims=True)
                    return embs / np.maximum(norm, 1e-8)

                self.logger.info("CLIP text encoder loaded from %s", clip_dir)
                return encode
            except Exception as exc:  # a bad directory falls back to the hash scorer
                self.logger.warning("CLIP text encoder load failed (%s); hash fallback", exc)
        # loud, like the random-weights surrogate warning: every success
        # rate, similarity and ANCOVA cell is scored by this encoder
        self.logger.warning(
            "No CLIP text encoder available (run.clip_model=%r) — scoring with the "
            "bag-of-words HASH stand-in; attack metrics are NOT comparable to the reference "
            "until a CLIP HF dir is mounted", self.run_cfg.get("clip_model"),
        )
        return _HashTextEncoder()

    def _build_victim(self):
        """``gen(params, batch, generator, sigma) -> tokens [B, T]``: the
        batch's image plus ``sigma * N(0, 1)`` from ``generator``, then the
        greedy decode, without autograd (the kernels have no backward)."""
        cfg = self.model.cfg
        eos = self.model.tokenizer.eos_token_id
        pad = self.model.tokenizer.pad_token_id
        max_new = self.max_new_tokens

        def gen(params, batch, generator, sigma: float) -> torch.Tensor:
            with torch.no_grad():
                image = batch["image"]
                noise = torch.randn(image.shape, generator=generator, device=image.device,
                                    dtype=image.dtype)
                batch = dict(batch, image=image + sigma * noise)
                return generate_greedy(params, cfg, batch, max_new, eos, pad)

        return gen

    # ------------------------------------------------------------------
    def caption(self, pixels: np.ndarray, instruction: str, stream: Sequence[int],
                sigma: Optional[float] = None) -> str:
        """Victim caption of a [0, 1]-pixel image [H, W, 3] (normalized with
        the dataset processor's mean/std, ``_pixel_stats``); ``sigma`` is
        the victim-side smoothing level (default ``run.noise_level``);
        ``stream`` names the draw (``caption_key``)."""
        if sigma is None:
            sigma = self.noise_level
        mean, std = self._pixel_stats()
        size = self.model.cfg.vit.img_size
        img = torch.from_numpy(np.asarray((pixels - mean) / std, np.float32))
        img = _resize(img[None].to(self.device), size)
        spec = BatchSpec(seq_len=self.seq_len, num_img_tokens=self.model.cfg.num_img_tokens)
        prompt = build_gen_batch(self.model.tokenizer, [instruction], spec)
        batch = {k: torch.from_numpy(v).long().to(self.device) for k, v in prompt.items()}
        batch["image"] = img
        generator = torch.Generator(device=self.device)
        generator.manual_seed(caption_key(self.seed, stream, sigma))
        tokens = self._victim_generate(self.model.params, batch, generator, float(sigma))
        return clean_answer(decode_until_eos(self.model.tokenizer, tokens[0].cpu().numpy()))

    # ------------------------------------------------------------------
    def _pixel_stats(self):
        """The vis processor's normalization constants (config-overridable:
        the epsilon ball and the clipping live in its pixel space)."""
        proc = getattr(getattr(self, "_pixel_dataset", None), "vis_processor", None)
        mean = np.asarray(getattr(proc, "mean", CLIP_MEAN), np.float32)
        std = np.asarray(getattr(proc, "std", CLIP_STD), np.float32)
        return mean, std

    def run(self) -> Dict[str, Any]:
        dataset = self._dataset()
        self._pixel_dataset = dataset
        limit = int(self.max_images) if self.max_images else len(dataset)
        limit = min(limit, len(dataset))
        mean, std = self._pixel_stats()

        def to_pixels(item):
            # de-normalize processor output back to [0,1] pixels
            return np.clip(np.asarray(item["image"]) * std + mean, 0.0, 1.0).astype(np.float32)

        attacks = {enc.name: make_pgd_attack([enc], self.epsilon, self.step_size, self.steps)
                   for enc in self.encoders}
        self._embed_fns = {
            enc.name: (lambda p, x, enc=enc: embed_images([enc], {enc.name: p}, x)[enc.name])
            for enc in self.encoders
        }

        # noise grid: every backbone at each sigma of run.sigma_grid; without
        # it the run is the single configured noise_level
        sigma_grid = self.run_cfg.get("sigma_grid")
        sigmas = [float(s) for s in sigma_grid] if sigma_grid else [self.noise_level]

        rows: List[Dict[str, Any]] = []
        results_path = os.path.join(self.output_dir, "attack_results.jsonl")
        with open(results_path, "w") as sink:
            for idx in range(limit):
                item = dataset[idx]
                target_item = dataset[(idx + 1) % len(dataset)]
                target_text = self._target_text(target_item)
                pixels = to_pixels(item)
                target_pixels = to_pixels(target_item)
                instruction = item.get("instruction_input",
                                       "<Img><ImageHere></Img> Describe this image.")

                # the PGD transfer stage sees only the surrogate: crafted once
                # per backbone and reused across the sigma grid; the RGF query
                # stage talks to the sigma-smoothed victim, so it refines per
                # sigma below
                transfer_adv = {
                    enc.name: self._transfer_attack(attacks[enc.name], pixels, target_pixels, enc)
                    for enc in self.encoders
                }

                for s_idx, sigma in enumerate(sigmas):
                    # the clean caption is backbone-independent
                    clean_cap = self.caption(pixels, instruction, (0, idx), sigma)
                    for b_idx, enc in enumerate(self.encoders):
                        adv = transfer_adv[enc.name]
                        if self.rgf_queries > 0:
                            adv = self._rgf_stage(adv, pixels, target_text, enc,
                                                  (idx, s_idx, b_idx), instruction, sigma)
                        row = self._score(idx, item, enc.name, b_idx, pixels, adv,
                                          target_text, clean_cap, instruction, sigma)
                        rows.append(row)
                        sink.write(json.dumps(row) + "\n")
                        sink.flush()
                        self.logger.info(
                            "attack[%d] sigma=%s backbone=%s success=%s d_sim=%.4f",
                            idx, sigma, enc.name, row["success"],
                            row["adv_similarity"] - row["clean_similarity"],
                        )

        summary = self._summarize(rows)
        with open(os.path.join(self.output_dir, "attack_summary.json"), "w") as handle:
            json.dump(summary, handle, indent=2)
        self._write_ancova_csv(rows)
        self.logger.info("attack summary: %s", summary)
        return summary

    # ------------------------------------------------------------------
    def _dataset(self):
        for name in self.config.datasets.keys():
            builder_cls = registry.get_builder_class(name)
            datasets = builder_cls(self.config.datasets.get(name) or {}).build_datasets()
            for split in ("val", "test", "train"):
                if split in datasets:
                    return datasets[split]
        raise RuntimeError("No dataset configured for attack eval")

    @staticmethod
    def _target_text(item) -> str:
        if "gt_answers" in item and item["gt_answers"]:
            return item["gt_answers"][0]
        return item.get("answer", "a photo")

    def _transfer_attack(self, attack, pixels, target_pixels, enc) -> np.ndarray:
        """Transfer stage: PGD toward the *target image's* surrogate
        embedding (the AttackVLM feature-matching objective)."""
        x = torch.from_numpy(pixels)[None].to(self.device)
        target = torch.from_numpy(target_pixels)[None].to(self.device)
        target_embeds = {enc.name: self._embed_fns[enc.name](enc.params, target)}
        return attack({enc.name: enc.params}, x, target_embeds)[0].cpu().numpy()

    def _rgf_stage(self, adv, pixels, target_text, enc, tag, instruction, sigma) -> np.ndarray:
        """RGF query stage against the sigma-smoothed victim, on the prompt
        ``_score`` judges with. ``tag`` is the (image, sigma, backbone)
        index triple; it namespaces both the victim caption stream and the
        RGF direction seed so no two stages of a run share draws."""
        text_enc = self.text_encoder
        target_emb = text_enc([target_text])[0]
        step_counter = [0]
        idx, s_idx, b_idx = tag

        def victim_score(p):
            step_counter[0] += 1
            cap = self.caption(p, instruction, (2, idx, s_idx, b_idx, step_counter[0]), sigma)
            emb = text_enc([cap])[0]
            return float(np.dot(emb, target_emb))

        return rgf_refine(
            victim_score, adv, pixels,
            epsilon=self.epsilon,
            queries=self.rgf_queries,
            iters=self.rgf_iters,
            seed=(self.seed, idx, s_idx, b_idx),
        )

    def _score(self, idx, item, backbone, b_idx, pixels, adv, target_text, clean_cap,
               instruction, sigma=None):
        if sigma is None:
            sigma = self.noise_level
        adv_cap = self.caption(adv, instruction, (1, idx, b_idx), sigma)
        embs = self.text_encoder([clean_cap, adv_cap, target_text])
        clean_sim = float(np.dot(embs[0], embs[2]))
        adv_sim = float(np.dot(embs[1], embs[2]))
        return {
            "index": idx,
            "question_id": int(item.get("question_id", idx)),
            "backbone": backbone,
            "sigma": float(sigma),
            "target_text": target_text,
            "clean_caption": clean_cap,
            "adv_caption": adv_cap,
            "clean_similarity": clean_sim,
            "adv_similarity": adv_sim,
            "similarity": adv_sim,
            "success": attack_success(clean_sim, adv_sim),
            "linf": float(np.max(np.abs(adv - pixels))),
        }

    def _summarize(self, rows) -> Dict[str, Any]:
        per_backbone = {}
        for name in self.backbone_names:
            sub = [r for r in rows if r["backbone"] == name]
            if sub:
                per_backbone[name] = sum(r["success"] for r in sub) / len(sub)
        sigmas = sorted({r["sigma"] for r in rows})
        summary = {
            "total": len(rows),
            "sigma_grid": sigmas,
            "epsilon": self.epsilon,
            "steps": self.steps,
            "success_rate_per_backbone": per_backbone,
            "overall_success_rate": sum(r["success"] for r in rows) / max(len(rows), 1),
        }
        if len(sigmas) > 1:
            # the reference's headline table: success rate per (backbone,
            # sigma) cell
            summary["success_rate_grid"] = {
                name: {
                    str(s): (
                        sum(r["success"] for r in cell) / len(cell)
                        if (cell := [r for r in rows
                                     if r["backbone"] == name and r["sigma"] == s])
                        else None
                    )
                    for s in sigmas
                }
                for name in self.backbone_names
            }
        if len({r["backbone"] for r in rows}) > 1:
            summary["ancova"] = ancova(rows)
        return summary

    def _write_ancova_csv(self, rows) -> None:
        path = os.path.join(self.output_dir, "attack_ancova.csv")
        with open(path, "w", newline="") as handle:
            writer = csv.DictWriter(
                handle,
                fieldnames=["index", "question_id", "backbone", "sigma", "clean_similarity",
                            "adv_similarity", "success", "linf"],
                extrasaction="ignore",
            )
            writer.writeheader()
            for row in rows:
                writer.writerow(row)
