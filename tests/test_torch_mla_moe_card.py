"""K1 (the routed experts), K2 (the latent decode) and the graphed
DeepSeek-V3 decode step on the card, at Moonlight-16B-A3B's widths, against
their plain versions and the eager step. This file imports no JAX; run it
on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_mla_moe_card.py
"""

import functools
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from llm_speech_summarization_tpu_torch.infer import generate as gen  # noqa: E402
from llm_speech_summarization_tpu_torch.kernels import latent_decode as ld  # noqa: E402
from llm_speech_summarization_tpu_torch.kernels import moe_experts as mx  # noqa: E402
from llm_speech_summarization_tpu_torch.models import mla_moe as mm  # noqa: E402

CFG = mm.mla_moe_preset("moonlight_16b_a3b")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest -m cuda "
                    "tests/test_torch_mla_moe_card.py)")
    return torch.device("cuda")


def _gap(got, want) -> float:
    """The widest difference over the widest value."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [128, 19200])  # ~12 and ~1,800 rows an expert
def test_routed_experts_against_the_plain_version(card, tokens):
    g = torch.Generator(device="cuda").manual_seed(tokens)
    E, D, I, k = CFG.n_routed_experts, CFG.hidden_size, CFG.moe_intermediate_size, 6
    x = torch.randn((tokens, D), device="cuda", generator=g).to(torch.bfloat16)
    wgu = (0.02 * torch.randn((E, 2 * I, D), device="cuda", generator=g)).to(torch.bfloat16)
    wd = (0.02 * torch.randn((E, D, I), device="cuda", generator=g)).to(torch.bfloat16)
    sel = torch.rand((tokens, E), device="cuda", generator=g).topk(k, dim=-1).indices
    routing = mx.sort_by_expert(sel, E)
    rows = tokens * k
    launches = mx.moe_gateup.launches
    h = mx.moe_gateup(x, routing.tok, routing.offsets, wgu)
    assert mx.moe_gateup.launches == launches + 1
    h_plain = mx.moe_gateup_reference(x, routing.tok, routing.offsets, wgu)
    # bf16 outputs rounded at the same points; the float32 sums' order
    # differs, which moves a rounding by one bf16 step at most
    assert _gap(h, h_plain) < 2e-2
    mean_gap = float((h.float() - h_plain.float()).abs().mean())
    assert mean_gap < 1e-3 * float(h_plain.float().abs().mean()) + 1e-6
    y = mx.moe_down(h, routing.offsets, wd)
    y_plain = mx.moe_down_reference(h, routing.offsets, wd)
    assert y.shape == (rows + 1, D) and torch.all(y[rows] == 0)
    assert _gap(y[:rows], y_plain[:rows]) < 1e-4  # float32 against float32
    # the combine's products and sums are rounded as the plain version's
    w = torch.rand((tokens, k), device="cuda", generator=g)
    launches = mx.combine.launches
    out = mx.combine(y, routing.dest, w)
    assert mx.combine.launches == launches + 1
    assert torch.equal(out, mx.combine_reference(y, routing.dest, w, torch.bfloat16))
    # repeats are bit-identical
    assert torch.equal(mx.moe_gateup(x, routing.tok, routing.offsets, wgu), h)
    assert torch.equal(mx.moe_down(h, routing.offsets, wd)[:rows], y[:rows])


@pytest.mark.cuda
# one block (a decode step's pairs), two blocks with one pair in the second
# (683 x 6 = 4,098), and a prefill's pairs over 29 blocks
@pytest.mark.parametrize("tokens,masked", [(128, False), (4, False), (1024, True), (683, False),
                                           (19200, False), (19200, True)])
def test_the_one_launch_sort_against_the_scan(card, tokens, masked):
    g = torch.Generator(device="cuda").manual_seed(tokens)
    E, k = CFG.n_routed_experts, CFG.num_experts_per_tok
    sel = torch.rand((tokens, E), device="cuda", generator=g).topk(k, dim=-1).indices
    valid = torch.rand(tokens, device="cuda", generator=g) > 0.3 if masked else None
    launches = mx.sort_by_expert.launches
    got = mx.sort_by_expert(sel, E, valid)
    assert mx.sort_by_expert.launches == launches + 1
    want = mx.sort_by_expert_reference(sel, E, valid)
    assert torch.equal(got.offsets, want.offsets) and torch.equal(got.counts, want.counts)
    # the same pairs in each expert's segment, whatever their order there
    nk = tokens * k
    keep = torch.ones(tokens, dtype=torch.bool, device="cuda") if valid is None else valid
    pairs = torch.arange(nk, device="cuda")
    routed = keep.repeat_interleave(k)
    assert torch.all(got.dest.reshape(-1)[~routed] == nk)
    d = got.dest.reshape(-1)[routed]
    assert torch.equal(got.tok[d].long(), pairs[routed] // k)
    seg = torch.searchsorted(got.offsets[1:].contiguous(), d.to(torch.int32), right=True)
    assert torch.equal(seg, sel.reshape(-1)[routed])


def _latent_case(B, T, S, off, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    cache = mm.init_latent_cache(CFG, B, S, device="cuda")
    old_c = torch.randn((B, off, 512), device="cuda", generator=g).to(torch.bfloat16)
    old_pe = torch.randn((B, off, 64), device="cuda", generator=g).to(torch.bfloat16)
    mm._write_latents(cache, 1, 0, old_c, old_pe)
    q = torch.randn((B, T, 16, 576), device="cuda", generator=g).to(torch.bfloat16)
    c_new = torch.randn((B, T, 512), device="cuda", generator=g).to(torch.bfloat16)
    pe_new = torch.randn((B, T, 64), device="cuda", generator=g).to(torch.bfloat16)
    pads = torch.randint(0, off // 2, (B,), device="cuda", generator=g).to(torch.int32)
    offsets = torch.full((B,), off, dtype=torch.int32, device="cuda")
    return cache, q, c_new, pe_new, pads, offsets


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,S,off", [(128, 1, 320, 290), (4, 1, 320, 290), (4, 2, 320, 200),
                                       (16, 1, 96, 40)])
def test_latent_decode_against_the_plain_version(card, B, T, S, off):
    cache, q, c_new, pe_new, pads, offsets = _latent_case(B, T, S, off, seed=B * 10 + T)
    plain_cache = mm.LatentCache(*(t.clone() for t in cache))
    launches = ld.latent_decode.launches
    got = ld.latent_decode(q, *cache, c_new, pe_new, pads, offsets, 1, max_offset=off,
                           scale=CFG.softmax_scale)
    assert ld.latent_decode.launches == launches + 1
    want = ld.latent_decode_reference(q, *plain_cache, c_new, pe_new, pads, offsets, 1,
                                      CFG.softmax_scale)
    # both round p to bf16 and the output to bf16; the sums' order differs
    assert _gap(got, want) < 2e-2
    # the fresh latents' int8 values and scales are written bit for bit
    for a, b in zip(cache, plain_cache):
        assert torch.equal(a, b)
    again = ld.latent_decode(q, *mm.LatentCache(*(t.clone() for t in plain_cache)), c_new, pe_new,
                             pads, offsets, 1, max_offset=off, scale=CFG.softmax_scale)
    assert torch.equal(again, got)


def _moonlight_params(seed):
    """Seeded N(0, 0.02) weights drawn in bf16 on the card, norms at 1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    flat = {}
    for path, shape in mm.param_shapes(CFG).items():
        t = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
        flat[path] = t.fill_(1.0) if path in mm.NORMS else t.normal_(0.0, 0.02, generator=g)
    return mm.nest(flat)


@pytest.fixture(scope="module")
def moonlight(card):
    return _moonlight_params(7)


def _spy_logits(monkeypatch):
    seen = []
    sample = gen._sample

    def spy(logits, *a, **kw):
        seen.append(logits.clone())
        return sample(logits, *a, **kw)

    monkeypatch.setattr(gen, "_sample", spy)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("B", [128, 4])
def test_graphed_moonlight_step_matches_eager(card, moonlight, B, monkeypatch):
    g = torch.Generator(device="cuda").manual_seed(B)
    T = 160
    embeds = torch.randn((B, T, CFG.hidden_size), device="cuda", generator=g).to(torch.bfloat16)
    mask = torch.ones((B, T), dtype=torch.bool, device="cuda")
    for b in range(B):
        mask[b, : (b * 37) % 90] = False
    embeds = embeds * mask[..., None].to(embeds.dtype)
    run = functools.partial(gen.greedy_generate, moonlight, CFG, embeds, mask, max_new_tokens=12,
                            eos_id=-1, cache_dtype=torch.int8)
    with monkeypatch.context() as m:
        m.setattr(mm, "graphs_engage", lambda *a: False)
        eager_logits = _spy_logits(m)
        eager_counts = Counter()
        eager = run(counts=eager_counts)
    graphed_logits = _spy_logits(monkeypatch)
    k2 = ld.latent_decode.launches
    first, second = Counter(), Counter()
    graphed = run(counts=first)
    again = run(counts=second)
    steps = first["decode_steps"]
    assert steps == eager_counts["decode_steps"] == 11
    assert eager_counts["decode_graph_steps"] == 0
    assert first["decode_graph_captures"] == 1 and first["decode_graph_steps"] == steps - 1
    assert second["decode_graph_captures"] == 0 and second["decode_graph_steps"] == steps
    # K2 launched eagerly at every layer of every step (the warm-up's too)
    assert ld.latent_decode.launches - k2 == 2 * CFG.num_layers * steps
    for toks in (graphed, again):
        assert torch.equal(toks[0], eager[0]) and torch.equal(toks[1], eager[1])
    n = len(eager_logits)
    assert len(graphed_logits) == 2 * n
    for i, want in enumerate(eager_logits):
        assert torch.equal(graphed_logits[i], want), i
        assert torch.equal(graphed_logits[n + i], want), i
