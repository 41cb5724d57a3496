"""The piecewise CUDA graphs of a decode step (``models/llama.py``
``graphs_engage``, ``piecewise_decode``, ``_graphed_step``).

On the CPU: the num_layers + 1 pieces run eagerly give the decode step's
logits and cache writes bit for bit, in every attention mode; the rule
that engages the graphs, one condition a case; ``greedy_generate``'s
wiring (with the rule let through on the CPU and the pieces run eagerly in
the graphs' place) and its refusals (the CPU, a ``tp_group``).

On the card (``-m cuda``; this file imports no JAX, so run it there with
``--noconftest``): ``greedy_generate`` with the graphs against the eager
step at MiniChat's widths over an int8 cache, B = 128 and B = 4, B2
launched once a layer each graphed step, a second call capturing nothing,
and a capture while another thread runs an encoder on a side stream.

    python -m pytest --noconftest -m cuda tests/test_torch_decode_graphs.py
"""

import functools
import threading
from collections import Counter
from dataclasses import replace

import pytest
import torch
import torch.distributed as dist

from llm_speech_summarization_tpu_torch.infer import generate as gen
from llm_speech_summarization_tpu_torch.infer.paged import PagedKVCache
from llm_speech_summarization_tpu_torch.kernels import fused_decode as fd
from llm_speech_summarization_tpu_torch.models import llama

torch.set_num_threads(1)


def _params(cfg, kind, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    dtype = torch.float32 if kind == "float32" else torch.bfloat16
    p = llama.init_llama_params(g, cfg, dtype=dtype, device=device)
    if kind == "int8":  # the engine's serving layout
        p = llama.quantize_llama_params(llama.fuse_llama_params(p))
    return p


def _prompt(cfg, B, L, dtype, device="cpu", seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    embeds = 0.5 * torch.randn((B, L, cfg.hidden_size), generator=g, device=device)
    pads = torch.randint(0, L // 2, (B,), generator=g, device=device)
    pads[0] = 0
    mask = torch.arange(L, device=device)[None, :] >= pads[:, None]
    return embeds.to(dtype), mask


CASES = {  # params, cache dtype, attn_impl, tied head
    "int8_b2": ("int8", torch.int8, "auto", False),
    "bf16_b3": ("bf16", torch.bfloat16, "auto", True),
    "int8_b8": ("int8", torch.int8, "pallas", False),
    "f32_b3": ("float32", torch.float32, "auto", True),
}


@pytest.mark.parametrize("case", list(CASES))
@torch.no_grad()
def test_pieces_match_the_decode_step_bit_for_bit(case):
    kind, cache_dtype, attn_impl, tied = CASES[case]
    cfg = replace(llama.llama_preset("tiny"), tie_embeddings=tied)
    p = _params(cfg, kind)
    B, L, steps = 3, 7, 4
    embeds, mask = _prompt(cfg, B, L, p["final_norm"].dtype)
    cache = llama.init_kv_cache(cfg, B, L + steps, dtype=cache_dtype)
    out = llama.llama_forward(p, cfg, inputs_embeds=embeds, attn_mask=mask, kv_cache=cache,
                              cache_offset=0, last_logit_only=True)
    lens = mask.to(torch.int32).sum(dim=1)
    pads = (L - lens).to(torch.int32)
    ids = torch.argmax(out.logits[:, -1], dim=-1).to(torch.int32)
    eager_cache = llama.KVCache(*(None if t is None else t.clone() for t in cache))
    for step in range(steps):
        positions = (lens + step)[:, None]
        want = llama.llama_forward(p, cfg, input_ids=ids[:, None], positions=positions,
                                   kv_cache=eager_cache, cache_offset=L + step,
                                   kv_pad_lens=pads, attn_impl=attn_impl).logits
        offsets, pad_lens, bound = llama._dense_windows(L + step, None, pads, B, "cpu")
        attend = functools.partial(llama._dense_attend, cache, pad_lens, offsets, bound,
                                   attn_impl == "pallas")
        got = llama.piecewise_decode(p, cfg, ids[:, None].long(), positions, attend)
        assert got.shape == want.shape == (B, 1, cfg.vocab_size)
        assert torch.equal(got, want), f"step {step}"
        for a, b in zip(cache, eager_cache):
            assert a is None or torch.equal(a, b)
        ids = torch.argmax(got[:, 0], dim=-1).to(torch.int32)


def _dense():
    return llama.KVCache(torch.zeros(1), torch.zeros(1))


ENGAGE = {  # condition broken: (device, cache, kv_pad_lens, cache_offset, T, tp_group)
    "engages": ("cuda", _dense, True, 9, 1, None),
    "cpu": ("cpu", _dense, True, 9, 1, None),
    "paged_cache": ("cuda", lambda: PagedKVCache(*[torch.zeros(1)] * 5), True, 9, 1, None),
    "prefill": ("cuda", _dense, False, 0, 1, None),
    "verification_chunk": ("cuda", _dense, True, 9, 4, None),
    "per_row_offsets": ("cuda", _dense, True, torch.full((3,), 9), 1, None),
    "tp_group": ("cuda", _dense, True, 9, 1, object()),
}


@pytest.mark.parametrize("case", list(ENGAGE))
def test_graph_rule(case):
    device, cache, pads, offset, T, tp_group = ENGAGE[case]
    pads = torch.zeros(3, dtype=torch.int32) if pads else None
    assert llama.graphs_engage(torch.device(device), cache(), pads, offset, T,
                               tp_group) == (case == "engages")


@pytest.fixture
def world_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _generate(cfg, p, embeds, mask, counts=None, tp_group=None, **kw):
    return gen.greedy_generate(p, cfg, embeds, mask, max_new_tokens=6, eos_id=-1,
                               cache_dtype=torch.int8, counts=counts, tp_group=tp_group, **kw)


@pytest.mark.parametrize("mode", ["cpu", "tp_group", "graphed_on_cpu"])
def test_greedy_generate_takes_the_graphs_where_the_rule_lets_it(mode, monkeypatch, request):
    """``graphed_on_cpu``: the rule's device condition let through and the
    pieces run eagerly in the graphs' place, so every decode step takes the
    graph path with unchanged tokens; ``tp_group`` (a one-rank group, the
    device condition let through too) and the plain CPU never do."""
    cfg = replace(llama.llama_preset("tiny"), tie_embeddings=False)
    p = _params(cfg, "int8")
    embeds, mask = _prompt(cfg, 4, 9, p["final_norm"].dtype)
    want = _generate(cfg, p, embeds, mask, attn_impl="pallas")
    group = request.getfixturevalue("world_group") if mode == "tp_group" else None
    if mode != "cpu":
        rule = llama.graphs_engage
        monkeypatch.setattr(llama, "graphs_engage",
                            lambda dev, *a: rule(torch.device("cuda"), *a))

        def pieces(params, cfg, ids, positions, attend, counts):
            counts["decode_graph_steps"] += 1
            return llama.piecewise_decode(params, cfg, ids.long(), positions, attend)

        monkeypatch.setattr(llama, "_graphed_step", pieces)
    counts = Counter()
    got = _generate(cfg, p, embeds, mask, counts=counts, tp_group=group, attn_impl="pallas")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert counts["decode_steps"] == 5
    graphed = counts["decode_steps"] if mode == "graphed_on_cpu" else 0
    assert counts["decode_graph_steps"] == graphed
    assert counts["decode_graph_captures"] == 0


# --- on the card ------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest -m cuda "
                    "tests/test_torch_decode_graphs.py)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def minichat(card):
    """MiniChat-2-3B's widths, seeded random weights in the engine's int8
    serving layout."""
    cfg = llama.llama_preset("minichat_3b")
    return cfg, _params(cfg, "int8", device="cuda", seed=7)


def _spy_logits(monkeypatch):
    seen = []
    sample = gen._sample

    def spy(logits, *a, **kw):
        seen.append(logits.clone())
        return sample(logits, *a, **kw)

    monkeypatch.setattr(gen, "_sample", spy)
    return seen


def _spy_b2(monkeypatch):
    calls = Counter()
    launch = fd._launch

    def spy(*a, **kw):
        calls["b2"] += 1
        return launch(*a, **kw)

    monkeypatch.setattr(fd, "_launch", spy)
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("B", [128, 4])
def test_graphed_generate_matches_eager_on_card(card, minichat, B, monkeypatch):
    cfg, p = minichat
    embeds, mask = _prompt(cfg, B, 160, torch.bfloat16, device="cuda", seed=B)
    run = functools.partial(gen.greedy_generate, p, cfg, embeds, mask, max_new_tokens=24,
                            eos_id=-1, cache_dtype=torch.int8)
    rule = llama.graphs_engage
    with monkeypatch.context() as m:
        m.setattr(llama, "graphs_engage", lambda *a: False)
        eager_logits = _spy_logits(m)
        eager_counts = Counter()
        eager = run(counts=eager_counts)
    assert llama.graphs_engage is rule
    first_logits = _spy_logits(monkeypatch)
    b2 = _spy_b2(monkeypatch)
    first, second = Counter(), Counter()
    graphed = run(counts=first)
    n_first = b2["b2"]
    again = run(counts=second)
    steps = first["decode_steps"]
    assert steps == eager_counts["decode_steps"] == 23
    assert eager_counts["decode_graph_steps"] == eager_counts["decode_graph_captures"] == 0
    # the first call: one eager warm-up step, then the capture; the second
    # captures nothing and replays every step
    assert first["decode_graph_captures"] == 1 and first["decode_graph_steps"] == steps - 1
    assert second["decode_graph_captures"] == 0 and second["decode_graph_steps"] == steps
    assert n_first == cfg.num_layers * steps  # B2 launched eagerly at every layer
    assert b2["b2"] == 2 * cfg.num_layers * steps
    for toks in (graphed, again):
        assert torch.equal(toks[0], eager[0]) and torch.equal(toks[1], eager[1])
    assert len(first_logits) == len(eager_logits) * 2
    for i, want in enumerate(eager_logits):
        for got in (first_logits[i], first_logits[len(eager_logits) + i]):
            if not torch.equal(got, want):
                gap = float((got - want).abs().max())
                scale = float(want.abs().max())
                print(f"B={B} step {i}: logits differ by {gap:.3e} (scale {scale:.3e})")
                assert gap <= 1e-3 * scale


@pytest.mark.cuda
def test_capture_beside_an_encoder_on_a_side_stream(card, minichat):
    """A capture (a batch size no set has yet) while another thread runs
    HuBERT-large forwards on its own stream, as the bulk path's prompt
    builder does."""
    from llm_speech_summarization_tpu_torch.models import hubert

    cfg, p = minichat
    hcfg = hubert.hubert_preset("hubert_large")
    hp = hubert.init_hubert_params(torch.Generator(device="cuda").manual_seed(3), hcfg,
                                   device="cuda")
    wav = torch.randn((8, 16000 * 8), device="cuda").to(torch.bfloat16)
    stop, ran, errors = threading.Event(), threading.Event(), []

    def encoder():
        side = torch.cuda.Stream()
        try:
            with torch.no_grad(), torch.cuda.stream(side):
                while not stop.is_set():
                    hubert.hubert_forward(hp, hcfg, wav)
                    side.synchronize()
                    ran.set()
        except Exception as e:  # noqa: BLE001
            errors.append(e)
            ran.set()

    embeds, mask = _prompt(cfg, 20, 96, torch.bfloat16, device="cuda", seed=20)
    run = functools.partial(gen.greedy_generate, p, cfg, embeds, mask, max_new_tokens=8,
                            eos_id=-1, cache_dtype=torch.int8)
    counts = Counter()
    thread = threading.Thread(target=encoder)
    thread.start()
    try:
        assert ran.wait(120)
        got = run(counts=counts)
    finally:
        stop.set()
        thread.join(120)
    assert not errors and not thread.is_alive()
    assert counts["decode_graph_captures"] == 1 and counts["decode_graph_steps"] == 6
    with pytest.MonkeyPatch.context() as m:
        m.setattr(llama, "graphs_engage", lambda *a: False)
        want = run()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
