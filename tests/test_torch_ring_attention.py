"""The port's ring attention on 2 and 4 ranks (gloo on the CPU, one process
per rank) against the JAX package's ``ring_attention`` on a 2- or 4-device
slice of the virtual CPU mesh and against full attention: the outputs and
the gradients of q, k and v on the rows that see a key, within 5e-5 (the
bound of tests/test_ring_attention.py). And the mesh and backend rules of
``parallel/mesh.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ring_worker import run_ranks

from llm_speech_summarization_tpu.ops.attention import dot_product_attention, make_attention_bias
from llm_speech_summarization_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from llm_speech_summarization_tpu.parallel.mesh import mesh_from_devices
from llm_speech_summarization_tpu_torch.configs import YAML_DIR, load_config
from llm_speech_summarization_tpu_torch.parallel import (
    check_backend,
    default_backend,
    distributed_init,
    make_mesh,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("n,causal", [(2, True), (2, False), (4, True), (4, False)])
def test_ring_attention_matches_jax(tmp_path, n, causal):
    B, T, Hq, Hkv, Dh = 2, 64, 4, 2, 16
    rng = np.random.RandomState(n)
    q = rng.randn(B, T, Hq, Dh).astype(np.float32)
    k = rng.randn(B, T, Hkv, Dh).astype(np.float32)
    v = rng.randn(B, T, Hkv, Dh).astype(np.float32)
    starts = np.array([0, 21], np.int32)  # a pad that crosses a shard
    ends = np.array([T, 50 if not causal else T], np.int32)
    pos = np.arange(T)[None, :]
    keys = (pos >= starts[:, None]) & (pos < ends[:, None])
    rows = (pos >= starts[:, None]) if causal else np.ones_like(keys)  # rows that see a key
    w = rng.randn(B, T, Hq, Dh).astype(np.float32) * rows[:, :, None, None]

    mesh = mesh_from_devices(data=n, model=1, devices=jax.devices()[:n])

    def ring_loss(q, k, v):
        out = jax_ring_attention(q, k, v, jnp.asarray(starts), mesh, seq_axis="data",
                                 causal=causal, ends=jnp.asarray(ends))
        return jnp.sum(out * w), out

    def full_loss(q, k, v):
        bias = make_attention_bias(jnp.asarray(keys), jnp.asarray(keys), causal=causal)
        out = dot_product_attention(q, k, v, bias)
        return jnp.sum(out * w), out

    wants = {}
    for name, fn in (("jax ring", ring_loss), ("full", full_loss)):
        (_, out), grads = jax.jit(jax.value_and_grad(fn, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        wants[name] = (np.asarray(out), *(np.asarray(g) for g in grads))

    torch.save(dict(q=torch.from_numpy(q), k=torch.from_numpy(k), v=torch.from_numpy(v),
                    w=torch.from_numpy(w), starts=torch.from_numpy(starts),
                    ends=torch.from_numpy(ends), causal=causal), tmp_path / "inputs.pt")
    outs = run_ranks("ring_attention", tmp_path, n)
    got = [torch.cat([o[key] for o in outs], dim=1).numpy() for key in ("out", "dq", "dk", "dv")]
    for name, want in wants.items():
        np.testing.assert_allclose(got[0][rows], want[0][rows], atol=5e-5, rtol=0,
                                   err_msg=f"out vs {name}")
        for g, wg, what in zip(got[1:], want[1:], ("dq", "dk", "dv")):
            np.testing.assert_allclose(g, wg, atol=5e-5, rtol=0, err_msg=f"{what} vs {name}")
    assert np.isfinite(got[0]).all()


def _tiny(**mesh):
    cfg = load_config(str(YAML_DIR / "tiny_test.yaml"))
    for key, value in mesh.items():
        setattr(cfg.train.mesh, key, value)
    return cfg


def test_mesh_and_backend_rules(monkeypatch):
    # one process: seq 1 is the whole run; a data, seq or model axis needs
    # its ranks
    m = make_mesh(_tiny())
    assert (m.data, m.seq, m.model, m.rank, m.seq_group, m.model_group, m.data_group,
            m.is_main) == (1, 1, 1, 0, None, None, None, True)
    assert (m.data_rank, m.seq_rank, m.model_rank) == (0, 0, 0)
    with pytest.raises(ValueError, match="mesh 2,1,1 needs 2 ranks"):
        make_mesh(_tiny(data=2))
    for field in ("seq", "model"):
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_mesh(_tiny(**{field: 2}))
    # the backend a rank sees: NCCL with a card per rank, else gloo
    assert default_backend(1, 1) == default_backend(4, 8) == "nccl"
    assert default_backend(2, 1) == default_backend(1, 0) == "gloo"
    # a named backend: NCCL runs one rank per card; gloo takes ranks that
    # share a card
    check_backend("nccl", 1, 1)
    check_backend("gloo", 4, 1)
    check_backend("gloo", 2, 0)
    with pytest.raises(ValueError, match="duplicate GPU"):
        check_backend("nccl", 2, 1)
    with pytest.raises(ValueError, match="needs CUDA cards"):
        check_backend("nccl", 1, 0)
    with pytest.raises(ValueError, match="backend must be one of"):
        check_backend("mpi", 1, 0)
    # no run described, or one process: no process group
    for var in ("LSS_COORDINATOR", "MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert distributed_init() is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed_init() is False
    monkeypatch.setenv("LSS_COORDINATOR", "127.0.0.1:1")
    with pytest.raises(ValueError, match="form a set"):
        distributed_init()
    # the NCCL rule is checked before any init: 2 ranks on this host's cards
    monkeypatch.setenv("LSS_NUM_PROCESSES", "2")
    monkeypatch.setenv("LSS_PROCESS_ID", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="nccl"):
        distributed_init(backend="nccl")
    with pytest.raises(ValueError, match="needs CUDA cards"):
        distributed_init(backend="nccl", cpu=True)
    assert not torch.distributed.is_initialized()
