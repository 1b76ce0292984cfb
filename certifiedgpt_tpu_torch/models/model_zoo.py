"""Model holder, config parsing, checkpoint loading and seeded synthetic
initialization.

``MiniGPT4Model`` holds (cfg, params, tokenizer) as in
``certifiedgpt_tpu/models/model_zoo.py``. ``MiniGPT4Model.from_config``
reads a config's model block (a plain mapping) into a ``MiniGPT4Config``
(``config_from_block``), loads the four checkpoint families it names (a
Vicuna HF directory, ``eva_vit_g.pth``, the BLIP-2 Q-Former and the
MiniGPT-4 stage-2 checkpoint; a URL through the download cache of
``common/utils.py``) onto the target device, makes seeded synthetic weights
for every tower it does not load, and loads the alignment prompt pool
(``prompt_path``). The towers to load are decided before any
initialization, so a loaded tower is never drawn at random first; each
loaded layer stack is converted (``models/convert.py``) and, with
``quantize_llama``/``quantize_vit``, quantized one layer at a time on the
device. ``build_synthetic_params`` makes full-width weights from a seed
directly on the device, each layer stack at the serving int8 layout or in
its float dtype, module by module, so that the peak stays about one float
layer stack above the final footprint: the counterpart of the JAX
``bench.py::build_full_int8_params`` and of ``init_minigpt4`` followed by
``quantize_eva_vit``/``quantize_llama``. ``MiniGPT4Model`` is registered as
``minigpt4`` in the port's registry, which the agents build from;
``load_model``, ``load_preprocess``, ``load_model_and_preprocess`` and
``model_zoo`` are the JAX package's model-zoo surface over that registry.
"""

from __future__ import annotations

import dataclasses
import glob
import logging
import math
import os
import pickle
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from certifiedgpt_tpu_torch.common.registry import registry
from certifiedgpt_tpu_torch.common.utils import is_url, resolve_checkpoint
from certifiedgpt_tpu_torch.data.text import ByteTokenizer, HFTokenizer
from certifiedgpt_tpu_torch.models import layers as L
from certifiedgpt_tpu_torch.models.convert import (
    convert_eva_vit_state_dict,
    convert_llama_state_dict,
    convert_qformer_state_dict,
    load_projection,
)
from certifiedgpt_tpu_torch.models.eva_vit import EvaViTConfig
from certifiedgpt_tpu_torch.models.llama import LlamaConfig
from certifiedgpt_tpu_torch.models.minigpt4 import MiniGPT4, MiniGPT4Config
from certifiedgpt_tpu_torch.models.qformer import QFormerConfig
from certifiedgpt_tpu_torch.models.safetensors_io import SafetensorsDir
from certifiedgpt_tpu_torch.ops.quantization import int8_kernel_layout, quantize_kernel

logger = logging.getLogger(__name__)

#: model-block keys that name checkpoint files, as the JAX package reads them
CHECKPOINT_KEYS = ("llama_model", "eva_vit_g_pth", "vit_ckpt", "q_former_model",
                   "qformer_ckpt", "ckpt", "minigpt4_ckpt")


def _torch_load(path: str):
    """``torch.load`` onto the CPU, tensors only first; a checkpoint that
    pickles other objects beside its tensors (as LAVIS checkpoints do) is
    read in full. Checkpoint paths come from the user's own configs, so
    the files are trusted."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        return torch.load(path, map_location="cpu", weights_only=False)


def _resolve(path) -> Optional[str]:
    """A configured checkpoint as an existing local path: a URL is
    downloaded into the cache (a failed download is logged and gives
    None), a local path is returned if it exists, None otherwise."""
    if not path:
        return None
    path = str(path)
    if is_url(path):
        try:
            return resolve_checkpoint(path)
        except OSError as exc:
            logger.warning("checkpoint download failed (%s): %s", path, exc)
            return None
    return path if os.path.exists(path) else None


def load_llama_dir(path: str, cfg: LlamaConfig, device="cuda", quantize: bool = False):
    """The decoder tree of a Vicuna HF directory on ``device``: its
    ``*.safetensors`` shards read one tensor at a time
    (``safetensors_io.SafetensorsDir``), or without any, its
    ``pytorch_model*.bin`` shards (``torch.load``), converted layer by
    layer (``quantize``: int8 layer kernels)."""
    if glob.glob(os.path.join(path, "*.safetensors")):
        sd = SafetensorsDir(path)
        try:
            return convert_llama_state_dict(sd, cfg, device, quantize)
        finally:
            sd.close()
    shards = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if not shards:
        raise FileNotFoundError(f"{path} holds no *.safetensors or pytorch_model*.bin shard")
    sd = {}
    for shard in shards:
        sd.update(_torch_load(shard))
    return convert_llama_state_dict(sd, cfg, device, quantize)


def config_from_block(model_cfg: Mapping[str, Any]) -> MiniGPT4Config:
    """The ``MiniGPT4Config`` of a config's model block, as the JAX
    package's ``MiniGPT4Model.from_config`` (:163-223) resolves it:
    ``model_size`` ``tiny`` gives ``MiniGPT4Config.tiny()`` (which ignores
    ``image_size``, ``num_query_token``, ``vit_attn_impl`` and
    ``max_txt_len``, as there); any other size is the full model at
    ``image_size``, ``num_query_token``, ``vit_attn_impl`` and
    ``max_txt_len``. ``act_quant`` turns on W8A8 in the ViT and the decoder,
    ``kv_quant`` the int8 KV cache, ``max_position_embeddings`` sets the
    decoder's rotary table length, and the training knob ``remat`` (with
    ``remat_policy`` and ``remat_every``, which act only under it)
    recomputes decoder blocks in the backward."""
    if model_cfg.get("model_size", "full") == "tiny":
        cfg = MiniGPT4Config.tiny()
    else:
        cfg = MiniGPT4Config(
            vit=EvaViTConfig(
                img_size=int(model_cfg.get("image_size", 448)),
                attn_impl=str(model_cfg.get("vit_attn_impl", "xla")),
            ),
            qformer=QFormerConfig(num_query_tokens=int(model_cfg.get("num_query_token", 32))),
            llama=LlamaConfig(),
            max_txt_len=int(model_cfg.get("max_txt_len", 160)),
        )
    aq = bool(model_cfg.get("act_quant", False))
    kvq = bool(model_cfg.get("kv_quant", False))
    remat = bool(model_cfg.get("remat", False))
    mpe = model_cfg.get("max_position_embeddings")
    if aq or kvq or remat or mpe:
        cfg = dataclasses.replace(
            cfg,
            vit=dataclasses.replace(cfg.vit, act_quant=aq),
            llama=dataclasses.replace(
                cfg.llama, act_quant=aq, kv_quant=kvq, remat=remat,
                remat_policy=str(model_cfg.get("remat_policy", "full")),
                remat_every=int(model_cfg.get("remat_every", 1)),
                max_position_embeddings=int(mpe) if mpe else cfg.llama.max_position_embeddings,
            ),
        )
    return cfg


def load_prompt_pool(prompt_path, prompt_template="{}"):
    """Load the alignment prompt pool: keep only lines containing
    ``<ImageHere>`` and wrap each in the template. Returns [] when no path
    is configured or the file is missing."""
    if not prompt_path:
        return []
    path = str(prompt_path)
    if not os.path.exists(path):
        logger.warning("prompt_path %s not found; no prompt pool", path)
        return []
    with open(path, "r") as handle:
        raw = [line.strip() for line in handle if "<ImageHere>" in line]
    template = str(prompt_template or "{}")
    return [template.format(p) for p in raw]


@registry.register_model("minigpt4")
class MiniGPT4Model:
    """Holds the config, the model (one module per tower, parameters in the
    JAX layout), the tokenizer and the alignment prompt pool. ``params`` is
    the parameter dict the ``models.minigpt4`` functions take, rebuilt from
    the modules on every access: assigning into it changes nothing, so
    weights are replaced on the modules (``set_llama_proj``,
    ``make_trainable``)."""

    def __init__(self, cfg: MiniGPT4Config, params: Dict[str, Any], tokenizer,
                 prompt_list=()):
        self.cfg = cfg
        self.module = MiniGPT4(cfg, params)
        self.tokenizer = tokenizer
        # datasets without per-sample instructions draw from it
        self.prompt_list = list(prompt_list)

    @property
    def params(self) -> Dict[str, Any]:
        return self.module.tree()

    @property
    def device(self) -> torch.device:
        return self.module.llama.params.embed_tokens.embedding.device

    def _set_tree(self, key: str, tree: L.ParamTree) -> None:
        holder = getattr(self.module, key)
        if isinstance(holder, L.ParamTree):
            setattr(self.module, key, tree)
        else:  # a tower module holding its tree as .params
            holder.params = tree

    def set_llama_proj(self, tree: Mapping[str, torch.Tensor]) -> None:
        """Replace the projection's weights (``{"kernel", "bias"}``, e.g. a
        finetuned ``llama_proj``) on the module the forward reads."""
        self._set_tree("llama_proj", L.ParamTree(tree))

    def make_trainable(self, keys) -> Dict[str, Any]:
        """Make the top-level subtrees ``keys`` trainable on the modules the
        forward reads: each floating leaf becomes an ``nn.Parameter``
        (``requires_grad``; every other leaf stays a frozen buffer, so
        autograd records nothing for the frozen towers). Returns the
        trainable tree, whose parameters an optimizer updates in place."""
        params = self.params
        for key in keys:
            if key not in params:
                raise KeyError(f"run.trainable_keys names {key!r}, not one of {sorted(params)}")
            self._set_tree(key, L.ParamTree(params[key], trainable=True))
        params = self.params
        return {key: params[key] for key in keys}

    @classmethod
    def from_config(cls, model_cfg: Mapping[str, Any], device="cuda") -> "MiniGPT4Model":
        """The model of a config's model block (a plain mapping, e.g. the
        ``model:`` block of a certify YAML) on ``device``, in the JAX
        package's order: the Vicuna directory ``llama_model`` (and its
        tokenizer, ``HFTokenizer``; the byte-level tokenizer without it),
        ``eva_vit_g_pth``/``vit_ckpt``, ``q_former_model``/``qformer_ckpt``
        (its ``model`` dict, keys under ``Qformer.bert.``, the root
        ``query_tokens``), then the stage-2 ``ckpt``/``minigpt4_ckpt``
        (``llama_proj`` and ``ln_vision``). Every tower not loaded gets
        seeded synthetic weights (``init_seed``). Layer kernels are int8 with
        ``quantize_vit`` (ViT) and ``quantize_llama`` (decoder), loaded or
        not. A configured path that does not exist is logged and the random
        init kept; a file that does not parse raises."""
        cfg = config_from_block(model_cfg)
        for key in CHECKPOINT_KEYS:
            path = model_cfg.get(key)
            if path and not is_url(str(path)) and not os.path.exists(str(path)):
                logger.warning("%s path %s not found; using random init", key, path)
        quantize_vit = bool(model_cfg.get("quantize_vit", False))
        quantize_llama = bool(model_cfg.get("quantize_llama", False))
        llama_path = model_cfg.get("llama_model")
        load_llama = bool(llama_path and os.path.exists(str(llama_path)))
        vit_path = _resolve(model_cfg.get("eva_vit_g_pth") or model_cfg.get("vit_ckpt"))
        skip = tuple(name for name, loading in (("llama", load_llama), ("vit", bool(vit_path)))
                     if loading)
        params = build_synthetic_params(cfg, device, seed=int(model_cfg.get("init_seed", 0)),
                                        quantize_vit=quantize_vit,
                                        quantize_llama=quantize_llama, skip=skip)
        if load_llama:
            logger.info("Loading LLaMA weights from %s", llama_path)
            tokenizer = HFTokenizer(str(llama_path))
            params["llama"] = load_llama_dir(str(llama_path), cfg.llama, device, quantize_llama)
        else:
            tokenizer = ByteTokenizer()
        if vit_path:
            logger.info("Loading EVA ViT weights from %s", vit_path)
            params["vit"] = convert_eva_vit_state_dict(_torch_load(vit_path), cfg.vit, device,
                                                       quantize_vit)
        qformer_path = _resolve(model_cfg.get("q_former_model") or model_cfg.get("qformer_ckpt"))
        if qformer_path:
            logger.info("Loading Q-Former weights from %s", qformer_path)
            sd = _torch_load(qformer_path)
            converted = convert_qformer_state_dict(sd.get("model", sd), cfg.qformer,
                                                   prefix="Qformer.bert.", device=device)
            converted.setdefault("query_tokens", params["qformer"]["query_tokens"])
            params["qformer"] = converted
        ckpt = _resolve(model_cfg.get("ckpt") or model_cfg.get("minigpt4_ckpt"))
        if ckpt:
            logger.info("Loading MiniGPT-4 stage-2 checkpoint from %s", ckpt)
            sd = _torch_load(ckpt)
            load_projection(params, sd.get("model_state_dict", sd.get("model", sd)), device)
        prompt_list = load_prompt_pool(model_cfg.get("prompt_path"),
                                       model_cfg.get("prompt_template", "{}"))
        if prompt_list:
            logger.info("Loaded %d alignment prompts", len(prompt_list))
        return cls(cfg, params, tokenizer, prompt_list=prompt_list)


class _Init:
    """Seeded draws on one device."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def normal(self, shape, std: float, dtype=torch.float32) -> torch.Tensor:
        out = torch.randn(shape, generator=self.gen, device=self.device)
        return (out * std).to(dtype)

    def dense(self, d_in: int, d_out: int, dtype, bias: bool = True) -> Dict[str, torch.Tensor]:
        p = {"kernel": self.normal((d_in, d_out), 1.0 / math.sqrt(d_in), dtype)}
        if bias:
            p["bias"] = torch.zeros((d_out,), dtype=dtype, device=self.device)
        return p

    def stacked(self, layers: int, d_in: int, d_out: int, std: float, dtype,
                quantize: bool) -> Dict[str, torch.Tensor]:
        """A ``[L, in, out]`` layer kernel: int8 (``stacked_int8``) when
        ``quantize``, else ``{"kernel"}`` in ``dtype``."""
        if quantize:
            return self.stacked_int8(layers, d_in, d_out, std)
        return {"kernel": self.normal((layers, d_in, d_out), std, dtype)}

    def stacked_int8(self, layers: int, d_in: int, d_out: int,
                     std: float) -> Dict[str, torch.Tensor]:
        """A ``[L, in, out]`` int8 kernel with per-(layer, out-channel)
        scales, drawn in f32 one layer at a time and stored column-major
        for the int8 kernels."""
        kq = int8_kernel_layout(
            torch.empty((layers, d_in, d_out), dtype=torch.int8, device=self.device))
        scale = torch.empty((layers, d_out), dtype=torch.float32, device=self.device)
        for layer in range(layers):
            q = quantize_kernel(self.normal((d_in, d_out), std))
            kq[layer].copy_(q["kernel_q"])
            scale[layer].copy_(q["scale"])
        return {"kernel_q": kq, "scale": scale}

    def const(self, shape, value: float, dtype) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)


def _vit_params(init: _Init, cfg, quantize: bool) -> Dict[str, Any]:
    d, n, i, dt = cfg.embed_dim, cfg.depth, cfg.mlp_hidden, cfg.dtype
    patch_in = cfg.in_channels * cfg.patch_size ** 2

    def layer_dense(d_in, d_out, bias=True):
        p = init.stacked(n, d_in, d_out, 1.0 / math.sqrt(d_in), dt, quantize)
        if bias:
            p["bias"] = init.const((n, d_out), 0.0, dt)
        return p

    ln = {"scale": init.const((n, d), 1.0, dt), "bias": init.const((n, d), 0.0, dt)}
    return {
        "patch_embed": init.dense(patch_in, d, dt),
        "cls_token": init.normal((1, 1, d), 0.02, dt),
        "pos_embed": init.normal((1, cfg.seq_len, d), 0.02, dt),
        "layers": {
            "norm1": ln,
            "qkv": layer_dense(d, 3 * d, bias=False),
            "q_bias": init.const((n, d), 0.0, dt),
            "v_bias": init.const((n, d), 0.0, dt),
            "proj": layer_dense(d, d),
            "norm2": {k: v.clone() for k, v in ln.items()},
            "fc1": layer_dense(d, i),
            "fc2": layer_dense(i, d),
        },
    }


def _qformer_params(init: _Init, cfg) -> Dict[str, Any]:
    d, dw, dt = cfg.hidden_size, cfg.encoder_width, cfg.dtype

    def ln():
        return {"scale": init.const((d,), 1.0, dt), "bias": init.const((d,), 0.0, dt)}

    layers = {}
    for i in range(cfg.num_layers):
        lp = {
            "self_q": init.dense(d, d, dt), "self_k": init.dense(d, d, dt),
            "self_v": init.dense(d, d, dt), "self_out": init.dense(d, d, dt),
            "self_ln": ln(),
            "int_q": init.dense(d, cfg.intermediate_size, dt),
            "out_q": init.dense(cfg.intermediate_size, d, dt),
            "ffn_ln_q": ln(),
        }
        if cfg.has_cross_attention(i):
            lp.update({
                "cross_q": init.dense(d, d, dt), "cross_k": init.dense(dw, d, dt),
                "cross_v": init.dense(dw, d, dt), "cross_out": init.dense(d, d, dt),
                "cross_ln": ln(),
            })
        layers[f"layer_{i}"] = lp
    return {
        "query_tokens": init.normal((1, cfg.num_query_tokens, d), 0.02, dt),
        "embeddings_ln": ln(),
        "layers": layers,
    }


def _llama_params(init: _Init, cfg, quantize: bool) -> Dict[str, Any]:
    d, n, dt = cfg.hidden_size, cfg.num_layers, cfg.dtype
    hd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    inter = cfg.intermediate_size
    mods = {
        "q_proj": (d, hd), "k_proj": (d, kvd), "v_proj": (d, kvd), "o_proj": (hd, d),
        "gate_proj": (d, inter), "up_proj": (d, inter), "down_proj": (inter, d),
    }
    layers = {name: init.stacked(n, di, do, 0.02, dt, quantize)
              for name, (di, do) in mods.items()}
    layers["input_layernorm"] = {"scale": init.const((n, d), 1.0, dt)}
    layers["post_attention_layernorm"] = {"scale": init.const((n, d), 1.0, dt)}
    return {
        "embed_tokens": {"embedding": init.normal((cfg.vocab_size, d), 0.02, dt)},
        "layers": layers,
        "norm": {"scale": init.const((d,), 1.0, dt)},
        "lm_head": {"kernel": init.normal((d, cfg.vocab_size), 0.02, dt)},
    }


def build_synthetic_params(cfg: MiniGPT4Config, device="cuda", seed: int = 0,
                           quantize_vit: bool = True, quantize_llama: bool = True,
                           skip: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """Seeded random parameters in the JAX package's tree: with
    ``quantize_vit`` the ViT qkv/proj/fc1/fc2 layer kernels are int8, with
    ``quantize_llama`` the decoder layer kernels; every other leaf is in its
    float dtype. The towers named in ``skip`` (``"vit"``, ``"llama"``: the
    ones a checkpoint will fill) are left out."""
    init = _Init(seed, device)
    params = {}
    if "vit" not in skip:
        params["vit"] = _vit_params(init, cfg.vit, quantize_vit)
    params["ln_vision"] = {"scale": init.const((cfg.vit.embed_dim,), 1.0, cfg.vit.dtype),
                           "bias": init.const((cfg.vit.embed_dim,), 0.0, cfg.vit.dtype)}
    params["qformer"] = _qformer_params(init, cfg.qformer)
    # the projection is the trained leaf; f32 as in the JAX package
    params["llama_proj"] = init.dense(cfg.qformer.hidden_size, cfg.llama.hidden_size,
                                      torch.float32)
    if "llama" not in skip:
        params["llama"] = _llama_params(init, cfg.llama, quantize_llama)
    return params


def build_synthetic_model(cfg: MiniGPT4Config, device="cuda",
                          seed: int = 0) -> MiniGPT4Model:
    """Seeded random MiniGPT-4 at ``cfg``'s widths on ``device``, with the
    byte-level tokenizer, at the serving layout of the certify configs
    (``quantize_llama`` and ``quantize_vit`` on)."""
    params = build_synthetic_params(cfg, device, seed)
    return MiniGPT4Model(cfg, params, ByteTokenizer())


def load_model(name: str, model_cfg: Optional[Mapping[str, Any]] = None, device="cuda"):
    """The registered model ``name`` built from the model block
    ``model_cfg`` (``{"model_size": "tiny"}`` when None) on ``device``: the
    JAX package's ``load_model`` (certifiedgpt_tpu/models/model_zoo.py:91)."""
    model_cls = registry.get_model_class(name)
    if model_cls is None:
        raise KeyError(f"Unknown model '{name}'. Available: {registry.list_models()}")
    return model_cls.from_config(model_cfg or {"model_size": "tiny"}, device)


def load_preprocess(preprocess_cfg: Optional[Mapping[str, Any]] = None):
    """``(vis_processors, text_processors)``, each keyed by ``train`` and
    ``eval``, from a config's ``vis_processor``/``text_processor`` blocks
    (the BLIP-2 image processors and ``blip_caption`` by default)."""
    from certifiedgpt_tpu_torch.data import processors  # noqa: F401 (registration)

    cfg = preprocess_cfg or {}
    vis, text = {}, {}
    for split, default in (("train", "blip2_image_train"), ("eval", "blip2_image_val")):
        block = (cfg.get("vis_processor") or {}).get(split, {"name": default})
        vis[split] = registry.get_processor_class(block["name"]).from_config(block)
    for split in ("train", "eval"):
        block = (cfg.get("text_processor") or {}).get(split, {"name": "blip_caption"})
        text[split] = registry.get_processor_class(block["name"]).from_config(block)
    return vis, text


def load_model_and_preprocess(name: str, model_cfg: Optional[Mapping[str, Any]] = None,
                              preprocess_cfg: Optional[Mapping[str, Any]] = None,
                              device="cuda"):
    """``load_model`` and ``load_preprocess`` together: ``(model, vis, text)``."""
    model = load_model(name, model_cfg, device)
    vis, text = load_preprocess(preprocess_cfg)
    return model, vis, text


class ModelZoo:
    """The registered models: iterable, sized, and listed by ``repr``."""

    def __repr__(self) -> str:
        rows = ["=" * 40, f"{'Architectures':<30}", "=" * 40]
        rows += [f"{name:<30}" for name in registry.list_models()]
        return "\n".join(rows)

    def __iter__(self):
        return iter(registry.list_models())

    def __len__(self):
        return len(registry.list_models())


model_zoo = ModelZoo()
