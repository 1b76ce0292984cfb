"""Port parity of the look-ahead and the continuous scheduler, on the CPU.

- The port's and the JAX package's ``ContinuousCertifier`` get stub gens that
  decode to fixed answer streams per image: both dispatch the same chunks
  (rows, prompts, images), pull the items at the same moments and finalize
  the same results, in certify and predict modes, with refill, early
  cancellation, a one-class vocabulary and tail padding.
- At sigma 0, on the same weights, the port's continuous certify and
  predict agents write the JAX agents' rows and summaries (timing keys
  aside), and the serial agents' labels.
- ``make_sample_fn`` gives the same labels at every ``dispatch_window``,
  the early-stopped prefix included, and dispatches at most ``window``
  chunks past the last one it reads.
- ``generate(early_exit=True)`` gives the full loop's tokens while it
  launches fewer decode steps.
"""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_generate_gpu import CHAINS, EOS, PAD, chain_batch, chain_model, chain_tokens
from test_torch_launch import jax_tree, port_on_jax_weights, vqa  # noqa: F401 (fixtures)

from certifiedgpt_tpu.agents.base import setup_agent as j_setup_agent
from certifiedgpt_tpu.common.config import Config as JConfig
from certifiedgpt_tpu.data.text import ByteTokenizer as JByteTokenizer
from certifiedgpt_tpu.smoothing import continuous as JC
from certifiedgpt_tpu.smoothing.classifier import AnswerVocabulary as JVocab
from certifiedgpt_tpu_torch.agents.base import setup_agent
from certifiedgpt_tpu_torch.common.config import Config
from certifiedgpt_tpu_torch.data.text import ByteTokenizer
from certifiedgpt_tpu_torch.models import minigpt4 as TM
from certifiedgpt_tpu_torch.models.model_zoo import MiniGPT4Model
from certifiedgpt_tpu_torch.smoothing import classifier as TCL
from certifiedgpt_tpu_torch.smoothing import continuous as TC
from certifiedgpt_tpu_torch.smoothing.classifier import AnswerVocabulary, make_sample_fn

TIMING_KEYS = {"seconds", "elapsed_seconds", "mean_seconds_per_image", "images_per_hour"}
IMG = 4  # stub image side
SEQ = 24  # stub prompt length
T = 6  # stub tokens a row

# the gt answers of each stub item; the stream an item's draws decode to
ITEMS = [
    (["cat"] * 10, lambda d, rng: "cat"),                       # certifies early
    (["cat", "dog"] * 5, lambda d, rng: ("cat", "dog")[d % 2]),  # abstains early
    (["a"] * 10, lambda d, rng: "cat"),                         # one class: no draws
    (["two"] * 7 + ["3"] * 3, lambda d, rng: ("2", "2", "3")[d % 3]),
    (["red"] * 10, lambda d, rng: rng.choice(["red", "blue"], p=[0.9, 0.1])),
    (["yes"] * 6 + ["no"] * 4, lambda d, rng: rng.choice(["yes", "no", "zzz"])),
    (["dog"] * 10, lambda d, rng: "zzz"),                       # OTHER throughout
]


def _items(n):
    out = []
    for idx in range(n):
        answers, _ = ITEMS[idx % len(ITEMS)]
        out.append({"image": np.full((IMG, IMG, 3), float(idx), np.float32),
                    "instruction_input": f"<Img><ImageHere></Img> question {idx}?",
                    "gt_answers": answers, "question_id": 100 + idx})
    return out


class _Streams:
    """Token rows of each draw: draw ``d`` of the item whose image a row
    gathered decodes to that item's stream at ``d``. Records every chunk."""

    def __init__(self, tokenizer):
        self.tokenizer = tokenizer
        self.draws = {}
        self.chunks = []

    def tokens(self, rows, ids, am, pos, images):
        self.chunks.append({"rows": rows.tolist(), "ids": ids.tolist(), "am": am.tolist(),
                            "pos": pos.tolist(), "images": images.tolist()})
        out = np.zeros((len(rows), T), np.int64)
        for i, image in enumerate(images):
            idx = int(image[0, 0, 0])
            d = self.draws.get(idx, 0)
            self.draws[idx] = d + 1
            rng = np.random.default_rng([idx, d])
            text = str(ITEMS[idx % len(ITEMS)][1](d, rng))
            ids_ = self.tokenizer.encode(text)[: T - 1] + [self.tokenizer.eos_token_id]
            out[i, : len(ids_)] = ids_
        return out


class _JaxGen:
    def __init__(self):
        self.streams = _Streams(JByteTokenizer())

    def set_image_slot(self, bank, slot, image):
        return bank.at[slot].set(image)

    def __call__(self, params, bank, ids, am, pos, rows, key, sigma):
        rows = np.asarray(rows)
        return jnp.asarray(self.streams.tokens(rows, np.asarray(ids)[rows], np.asarray(am)[rows],
                                               np.asarray(pos)[rows], np.asarray(bank)[rows]))


class _TorchGen:
    def __init__(self):
        self.streams = _Streams(ByteTokenizer())

    def __call__(self, bank, ids, am, pos, rows, generator, sigma):
        return torch.from_numpy(self.streams.tokens(rows.numpy(), ids[rows].numpy(),
                                                    am[rows].numpy(), pos[rows].numpy(),
                                                    bank[rows].numpy()))


def _stub_model(tokenizer):
    cfg = types.SimpleNamespace(vit=types.SimpleNamespace(img_size=IMG), num_img_tokens=2)
    return types.SimpleNamespace(cfg=cfg, tokenizer=tokenizer, params=None,
                                 device=torch.device("cpu"))


class _Pulls:
    """A sequence of items that logs each pull into ``events``."""

    def __init__(self, items, events):
        self.items, self.events = items, events

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        self.events.append(("item", idx))
        return self.items[idx]


def _run_scheduler(side, n_items, **kw):
    jax_side = side == "jax"
    gen = _JaxGen() if jax_side else _TorchGen()
    cls = JC.ContinuousCertifier if jax_side else TC.ContinuousCertifier
    vocab_cls = JVocab if jax_side else AnswerVocabulary
    model = _stub_model(gen.streams.tokenizer)
    scheduler = cls(model, max_new_tokens=T, seq_len=SEQ, gen=gen, **kw)
    events, landed = [], []
    results = scheduler.run(
        _Pulls(_items(n_items), events), lambda text: text,
        lambda item: vocab_cls(item["gt_answers"]), seed=5,
        on_result=lambda res, job: landed.append((dict(res), job.decoded)),
        on_chunk=lambda k: events.append(("chunk", k)),
    )
    return {"results": results, "landed": landed, "events": events,
            "chunks": gen.streams.chunks}


@pytest.mark.parametrize("case", [
    dict(mode="certify", n0=4, n=12, num_slots=3, mc_batch=6, window=2,
         early_abstain=True, early_stop_radius=0.5),
    dict(mode="certify", n0=3, n=8, num_slots=2, mc_batch=5, window=1),
    dict(mode="certify", n0=2, n=5, num_slots=8, mc_batch=32, window=4, early_abstain=True),
    dict(mode="predict", n0=0, n=12, num_slots=3, mc_batch=8, window=3, early_abstain=True),
    dict(mode="predict", n0=0, n=7, num_slots=1, mc_batch=3, window=2),
], ids=["certify-early", "certify-refill", "certify-tail", "predict-early", "predict-one-slot"])
def test_scheduler_dispatches_and_finalizes_as_jax(case):
    """Same stub gens: the same chunks (rows, prompts, gathered images),
    the same item pulls between chunks, the same results in the same
    order, over refill, cancellation, a one-class vocabulary and tail
    padding."""
    kw = dict(case, sigma=0.5, alpha=0.05)
    want = _run_scheduler("jax", 10, **kw)
    got = _run_scheduler("torch", 10, **kw)
    assert got["chunks"] == want["chunks"]
    assert got["events"] == want["events"]
    assert got["results"] == want["results"]
    assert got["landed"] == want["landed"]
    assert all(len(c["rows"]) == case["mc_batch"] for c in got["chunks"])
    budget = case["n0"] + case["n"]
    draws = [d for _, d in got["landed"]]
    # the one-class item abstains without a draw
    assert got["results"][2] == {"label": -1, "radius": 0.0, "index": 2}
    assert [d for r, d in got["landed"] if r["index"] == 2] == [0]
    if case.get("early_abstain"):
        assert min(d for d in draws if d) < budget  # a job was cancelled early
    else:
        assert set(draws) == {0, budget}
    if case["mc_batch"] == 32:
        # 9 items x 7 draws in two chunks, the second padded by one row
        assert len(got["chunks"]) == 2


@pytest.mark.parametrize("kw,match", [
    (dict(n0=4, mode="predict"), "n0=0"),
    (dict(n0=0, mode="argmax"), "certify|predict"),
    (dict(n0=4, window=0), "window"),
    (dict(n0=4, num_slots=0), "num_slots"),
    (dict(n0=4, n=0), "n must be"),
    (dict(n0=0, mode="predict", early_stop_radius=0.5), "certify only"),
])
def test_scheduler_guards_match_jax(kw, match):
    args = dict(sigma=0.5, n=8, alpha=0.05, mc_batch=4, max_new_tokens=2, seq_len=16,
                gen=lambda *a: None)
    args.update(kw)
    for cls in (JC.ContinuousCertifier, TC.ContinuousCertifier):
        with pytest.raises(ValueError, match=match):
            cls(None, **args)


def test_mixed_gen_refuses_a_bank_of_another_shape():
    model = MiniGPT4Model.from_config({"model_size": "tiny"}, "cpu")
    gen = TC.make_mixed_generate_fn(model, 4, 2, num_slots=2, seq_len=48)
    img = model.cfg.vit.img_size
    bank = torch.zeros((2, img, img, 3))
    with pytest.raises(ValueError, match="ids_bank"):
        gen(bank, torch.zeros((2, 17), dtype=torch.long), torch.ones((2, 17), dtype=torch.long),
            torch.zeros((2,), dtype=torch.long), torch.zeros((4,), dtype=torch.long),
            torch.Generator().manual_seed(0), 0.5)


@pytest.mark.parametrize("dist", ["uniform", "gaussian"])
def test_mixed_noise_gathers_and_draws(dist):
    """The noise step gathers each row's slot and adds sigma times the
    draw of its generator: U[0, 1) under ``uniform``, N(0, 1) otherwise."""
    model = MiniGPT4Model.from_config({"model_size": "tiny"}, "cpu")
    gen = TC.make_mixed_generate_fn(model, 4, 2, num_slots=2, noise_dist=dist)
    bank = torch.stack([torch.zeros((8, 8, 3)), torch.full((8, 8, 3), 10.0)])
    rows = torch.tensor([1, 0, 0, 1])
    noisy = gen.noise_fn(bank, rows, torch.Generator().manual_seed(3), 0.5)
    draw = (torch.rand if dist == "uniform" else torch.randn)(
        (4, 8, 8, 3), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(noisy, bank[rows] + 0.5 * draw, rtol=0, atol=0)
    if dist == "uniform":
        assert float((noisy - bank[rows]).min()) >= 0.0


def _rows(path):
    return [{k: v for k, v in json.loads(line).items() if k not in TIMING_KEYS}
            for line in open(path).read().splitlines()]


def _summary(path):
    return {k: v for k, v in json.load(open(path)).items() if k not in TIMING_KEYS}


@pytest.mark.parametrize("agent,run_extra,mode", [
    ("image_text_certify", {}, "certify"),
    ("image_text_certify", {"early_abstain": True, "early_stop_radius": 0.5}, "certify"),
    ("image_text_predict", {"early_abstain": True}, "predict"),
    ("image_text_predict", {}, "predict"),
    ("image_text_certify", {"sigma_grid": [0.0, 0.5]}, "certify"),
    ("image_text_certify", {"vocab_mode": "global", "vocab_top_k": 4}, "certify"),
], ids=["certify", "certify-early", "predict-early", "predict", "sigma_grid", "vocab_global"])
def test_continuous_agents_match_jax_at_sigma_zero(vqa, port_on_jax_weights,  # noqa: F811
                                                   agent, run_extra, mode):
    """Same weights, sigma 0, more images than slots: the port's continuous
    rows (in the order they land) and summary equal the JAX agent's but for
    the timing keys, and the labels equal the port's serial run's."""
    name = f"cont-{mode}-{'-'.join(map(str, run_extra))}"
    run = dict(run_extra, continuous=True, active_images=3, max_images=5, mc_batch=8,
               dispatch_window=2)
    j_agent = j_setup_agent(JConfig(vqa(agent, f"jax-{name}", **run)))
    j_agent.run()
    t_agent = setup_agent(Config(vqa(agent, f"torch-{name}", **run)), device="cpu")
    t_result = t_agent.run()
    s_agent = setup_agent(Config(vqa(agent, f"serial-{name}",
                                     **dict(run, continuous=False))), device="cpu")
    s_agent.run()
    j_out, t_out, s_out = (vqa.root / "out" / f"{side}-{name}"
                           for side in ("jax", "torch", "serial"))
    sub = [""]
    if "sigma_grid" in run_extra:
        assert set(t_result["sweep"]) == {"0.0", "0.5"}
        assert json.load(open(t_out / "certify_sweep.json")).keys() == {"0.0", "0.5"}
        sub = ["sigma_0.0", "sigma_0.5"]
    for cell in sub:
        got = _rows(t_out / cell / f"{mode}_results.jsonl")
        want = _rows(j_out / cell / f"{mode}_results.jsonl")
        summary = json.load(open(t_out / cell / f"{mode}_summary.json"))
        assert summary["continuous"] is True
        assert summary["images_per_hour"] == pytest.approx(
            3600.0 / summary["mean_seconds_per_image"])
        assert [set(r) for r in got] == [set(r) for r in want]
        assert _summary(t_out / cell / f"{mode}_summary.json").keys() == _summary(
            j_out / cell / f"{mode}_summary.json").keys()
        if cell == "sigma_0.5":
            continue  # another random stream than the JAX package's
        assert got == want
        assert _summary(t_out / cell / f"{mode}_summary.json") == _summary(
            j_out / cell / f"{mode}_summary.json")
        assert all("elapsed_seconds" in json.loads(line) for line in
                   open(t_out / cell / f"{mode}_results.jsonl").read().splitlines())
        serial = {r["index"]: r for r in _rows(s_out / cell / f"{mode}_results.jsonl")}
        assert len(got) == len(serial) == 5
        for row in got:
            assert row["label"] == serial[row["index"]]["label"]
            assert row.get("radius") == serial[row["index"]].get("radius")
    if run_extra.get("early_abstain") and mode == "predict":
        assert all(r["draws"] < 16 for r in _rows(t_out / f"{mode}_results.jsonl"))


class _HashVocab:
    """Labels that depend on every token of a row (the tiny model at random
    weights decodes to text no real vocabulary holds)."""

    num_classes = 5

    def label_of(self, text):
        return sum(text.encode()) % self.num_classes


@pytest.mark.parametrize("stop_after", [None, 3])
def test_sample_fn_labels_do_not_depend_on_the_window(monkeypatch, stop_after):
    """Window 1, 2 and 4 give the same labels, also when ``should_stop``
    fires (a prefix of the full stream); the window bounds the chunks
    dispatched past the last one read; window 0 raises."""
    model = MiniGPT4Model.from_config({"model_size": "tiny"}, "cpu")
    calls = []
    generate = TCL.generate_greedy

    def counting(*args, **kwargs):
        calls.append(1)
        return generate(*args, **kwargs)

    monkeypatch.setattr(TCL, "generate_greedy", counting)
    image = np.random.RandomState(0).randn(model.cfg.vit.img_size,
                                           model.cfg.vit.img_size, 3).astype(np.float32)
    num, mc = 20, 3
    n_chunks = -(-num // mc)
    full = None
    for window in (1, 2, 4):
        calls.clear()
        fn = make_sample_fn(model, "<Img><ImageHere></Img> what?", _HashVocab(), 0.5,
                            mc_batch=mc, max_new_tokens=4, seq_len=48, window=window)
        stop = None if stop_after is None else (lambda labels: labels.size >= stop_after * mc)
        labels = fn(image, num, 7, should_stop=stop)
        if full is None:
            full = labels
            assert len(set(full.tolist())) > 1  # the labels really vary
        if stop_after is None:
            assert labels.tolist() == full.tolist() and len(calls) == n_chunks
        else:
            assert labels.size == stop_after * mc
            assert labels.tolist() == full[: labels.size].tolist()
            assert len(calls) == min(n_chunks, stop_after + window)
    with pytest.raises(ValueError, match="window"):
        make_sample_fn(model, "what?", _HashVocab(), 0.5, mc_batch=mc, window=0)


def test_sample_fn_window_checks_memory_for_the_window(monkeypatch):
    seen = []
    monkeypatch.setattr(TCL, "check_dispatch_window_hbm",
                        lambda window, *a, **k: seen.append(window))
    model = MiniGPT4Model.from_config({"model_size": "tiny"}, "cpu")
    make_sample_fn(model, "what?", _HashVocab(), 0.5, mc_batch=3, seq_len=48, window=3)
    assert seen == [3]


@pytest.mark.parametrize("rows", [[0, 1, 2, 3], [1, 1, 3], [0, 2]], ids=["mixed", "short", "spread"])
def test_early_exit_gives_the_full_loops_tokens(rows):
    """Rows that emit EOS at different steps: ``early_exit`` returns the
    full loop's tokens and launches fewer decode steps (on the CPU the
    flags are read as soon as they are written)."""
    model = chain_model()
    cfg, params = model.cfg, model.params
    steps = 9
    batch = chain_batch(model, rows)
    outs, launched = {}, {}
    for early in (False, True):
        TM.generate.decode_steps = 0
        outs[early] = TM.generate(params, cfg, batch, steps, EOS, PAD, early_exit=early)
        launched[early] = TM.generate.decode_steps
    assert torch.equal(outs[True], outs[False])
    assert outs[False].tolist() == chain_tokens(rows, steps)
    longest = max(len(CHAINS[r][1]) + 1 for r in rows)
    assert launched[False] == steps - 1
    assert launched[True] == longest  # the step after the last EOS sees all rows done
