"""The port's training losses against the JAX package's, on the same seeded
numpy inputs: values, and gradients with respect to the student side
(logits or final hidden states, the path to the encoder). The fused NTP +
LD loss is also held to the unfused losses on the full logits, with a
float32 head and with an int8 head and its per-row scales.

Tolerances are float32 (rtol 1e-5 on values, 1e-5 + 1e-4 relative on
gradients): the same formulas, summed in another order or chunked
differently over the vocabulary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_speech_summarization_tpu.ops import losses as jl
from llm_speech_summarization_tpu_torch.ops import losses as tl

torch.set_num_threads(1)


def _case(seed=0, B=3, W=7, V=50, D=16):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    loss_mask = rng.rand(B, W) > 0.3
    loss_mask[2] = False  # a sample with an empty window
    resp_mask = loss_mask | (rng.rand(B, W) > 0.5)
    return dict(
        s_logits=3 * f(B, W, V), t_logits=3 * f(B, W, V),
        labels=rng.randint(0, V, (B, W)).astype(np.int32),
        loss_mask=loss_mask, resp_mask=resp_mask,
        sh=f(B, W, D), th=f(B, W, D), head=0.5 * f(V, D),
        head_q=rng.randint(-127, 128, (V, D)).astype(np.int8),
        head_scale=(0.005 + 0.02 * rng.rand(V)).astype(np.float32),
    )


def _torch_value_and_grad(fn, x, *args):
    xt = torch.from_numpy(x).requires_grad_()
    out = fn(xt, *args)
    out.backward()
    return out.item(), xt.grad.numpy()


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=what)


def _close_grad(got, want, what):
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5, err_msg=what)


def test_response_cross_entropy_matches_jax():
    c = _case()
    lab, lm = c["labels"], c["loss_mask"]
    got, g = _torch_value_and_grad(tl.response_cross_entropy, c["s_logits"],
                                   torch.from_numpy(lab), torch.from_numpy(lm))
    fn = lambda x: jl.response_cross_entropy(x, jnp.asarray(lab), jnp.asarray(lm))  # noqa: E731
    want, wg = jax.value_and_grad(fn)(jnp.asarray(c["s_logits"]))
    _close(got, float(want), "value")
    _close_grad(g, wg, "grad")


def test_response_nll_sum_matches_jax():
    c = _case(1)
    s, n = tl.response_nll_sum(*(torch.from_numpy(c[k]) for k in ("s_logits", "labels",
                                                                    "loss_mask")))
    ws, wn = jl.response_nll_sum(*(jnp.asarray(c[k]) for k in ("s_logits", "labels",
                                                                 "loss_mask")))
    _close(s.item(), float(ws), "sum")
    assert n.item() == float(wn) == c["loss_mask"].sum()


def test_soft_cross_entropy_matches_jax():
    c = _case(2)
    t, m = torch.from_numpy(c["t_logits"]), torch.from_numpy(c["resp_mask"])
    got, g = _torch_value_and_grad(tl.soft_cross_entropy, c["s_logits"], t, m)
    fn = lambda x: jl.soft_cross_entropy(x, jnp.asarray(c["t_logits"]),  # noqa: E731
                                         jnp.asarray(c["resp_mask"]))
    want, wg = jax.value_and_grad(fn)(jnp.asarray(c["s_logits"]))
    _close(got, float(want), "value")
    _close_grad(g, wg, "grad")


@pytest.mark.parametrize("int8_head", [False, True])
@pytest.mark.parametrize("chunk", [16, 64])
def test_fused_ntp_ld_matches_jax(int8_head, chunk):
    """Both losses and d(ntp + 2 ld)/d(student hidden) against the JAX
    fused loss (chunk 16: a ragged last chunk; 64: one chunk)."""
    c = _case(3)
    head = c["head_q"] if int8_head else c["head"]
    scale = c["head_scale"] if int8_head else None
    rest = (c["labels"], c["loss_mask"], c["resp_mask"])
    sh = torch.from_numpy(c["sh"]).requires_grad_()
    ntp, ld = tl.fused_ntp_ld_losses(
        sh, torch.from_numpy(c["th"]), torch.from_numpy(head), *map(torch.from_numpy, rest),
        vocab_chunk=chunk, head_scale=None if scale is None else torch.from_numpy(scale))
    (ntp + 2 * ld).backward()

    def jfn(x):
        n, l_ = jl.fused_ntp_ld_losses(
            x, jnp.asarray(c["th"]), jnp.asarray(head), *map(jnp.asarray, rest),
            vocab_chunk=chunk, head_scale=None if scale is None else jnp.asarray(scale))
        return n + 2 * l_, (n, l_)

    (_, (wn, wl)), wg = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(c["sh"]))
    _close(ntp.item(), float(wn), "ntp")
    _close(ld.item(), float(wl), "ld")
    _close_grad(sh.grad.numpy(), wg, "d student hidden")


def test_fused_ntp_ld_matches_unfused_losses():
    """The fused loss equals response_cross_entropy + soft_cross_entropy on
    the full logits of the dequantized int8 head, in value and gradient."""
    c = _case(4)
    head = torch.from_numpy(c["head_q"]).float() * torch.from_numpy(c["head_scale"])[:, None]
    lab, lm, rm = (torch.from_numpy(c[k]) for k in ("labels", "loss_mask", "resp_mask"))
    th = torch.from_numpy(c["th"])
    sh1 = torch.from_numpy(c["sh"]).requires_grad_()
    ntp, ld = tl.fused_ntp_ld_losses(sh1, th, torch.from_numpy(c["head_q"]), lab, lm, rm,
                                     vocab_chunk=16,
                                     head_scale=torch.from_numpy(c["head_scale"]))
    (ntp + ld).backward()
    sh2 = torch.from_numpy(c["sh"]).requires_grad_()
    s_logits = sh2 @ head.t()
    ntp2 = tl.response_cross_entropy(s_logits, lab, lm)
    ld2 = tl.soft_cross_entropy(s_logits, th @ head.t(), rm)
    (ntp2 + ld2).backward()
    _close(ntp.item(), ntp2.item(), "ntp")
    _close(ld.item(), ld2.item(), "ld")
    _close_grad(sh1.grad.numpy(), sh2.grad.numpy(), "d student hidden")


def test_fused_ntp_ld_gives_teacher_and_head_no_gradient():
    c = _case(5)
    sh, th, head = (torch.from_numpy(c[k]).requires_grad_() for k in ("sh", "th", "head"))
    ntp, ld = tl.fused_ntp_ld_losses(sh, th, head, *(torch.from_numpy(c[k]) for k in
                                                     ("labels", "loss_mask", "resp_mask")))
    (ntp + ld).backward()
    assert sh.grad is not None and th.grad is None and head.grad is None


def test_feature_distillation_loss_matches_jax():
    rng = np.random.RandomState(6)
    L1, B, W, D = 4, 2, 5, 8
    s_h = rng.randn(L1, B, W, D).astype(np.float32)
    t_h = rng.randn(L1, B, W, D).astype(np.float32)
    mask = rng.rand(B, W) > 0.4
    layers = (0, 2, 3)
    got, g = _torch_value_and_grad(tl.feature_distillation_loss, s_h, torch.from_numpy(t_h),
                                   layers, torch.from_numpy(mask))
    fn = lambda x: jl.feature_distillation_loss(x, jnp.asarray(t_h), layers,  # noqa: E731
                                                jnp.asarray(mask))
    want, wg = jax.value_and_grad(fn)(jnp.asarray(s_h))
    _close(got, float(want), "value")
    _close_grad(g, wg, "grad")
