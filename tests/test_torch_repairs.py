"""Three faults of earlier slices of the port, repaired, each pinned here on
the CPU:

* ``transformer.init_stack`` allocates the (L, ...) leaves once and fills
  them layer by layer: seed-0 weights stay bitwise those of the former
  construction (L blocks, then ``torch.stack``), kept below as a copy.
* ``serve_continuous`` ends when the last request finishes at admission and
  the ring is empty (it indexed past the trace).
* K6 takes any d % 4 == 0: its plain version against the reference's
  interpret-mode kernel and jnp oracle at d = 2560 and 8192 (ids under the
  near-tie rule of ``ref.near_tie_check``), and the kernel's plan staging y
  in slices over d where it does not fit whole.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import get_config
from repro_torch.kernels import decode_step as ds
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import build
from repro_torch.models import transformer as T
from repro_torch.utils.tree import tree_map, tree_paths

torch.set_num_threads(1)


def _stacked_init(gen, cfg):
    """``init_stack`` as it was: every block, then one ``torch.stack`` per
    leaf (both copies alive at once)."""
    blocks = [T._init_block(gen, cfg) for _ in range(cfg.n_layers)]
    return {"stack": tree_map(lambda *xs: torch.stack(xs), *blocks)}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-1.3b"])
def test_init_stack_weights_are_bitwise_the_former_ones(arch, monkeypatch):
    cfg = get_config(arch, reduced=True)
    model = build(cfg)
    new = model.init(torch.Generator().manual_seed(0))
    monkeypatch.setattr(T, "init_stack", _stacked_init)
    old = model.init(torch.Generator().manual_seed(0))
    new_p, old_p = tree_paths(new), tree_paths(old)
    assert [k for k, _ in new_p] == [k for k, _ in old_p]
    for (k, a), (_, b) in zip(new_p, old_p):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.is_contiguous(), k
        assert torch.equal(a, b), k
    assert new["blocks"]["stack"]["norm1"]["scale"].shape[0] == cfg.n_layers


def test_serve_continuous_ends_when_the_last_request_finishes_at_admission():
    """gen_len 1: every request is done at admission, the ring is never
    used, and the loop must end after the last one instead of looking for a
    next arrival."""
    kw = dict(slots=2, n_requests=5, prompt_len=6, gen_len=1,
              arrival_rate=0.5, seed=3, device="cpu", verbose=False)
    res = serve.serve_continuous("qwen2-0.5b", **kw)
    arrivals, gens = serve.poisson_trace(5, 0.5, 3, 1)
    assert list(gens) == [1] * 5
    assert res.metrics["decode_steps"] == 0
    for r in range(5):
        rq = res.requests[r]
        assert rq["arrival"] == int(arrivals[r])
        assert rq["start"] == rq["finish"] >= rq["arrival"]
        assert len(res.tokens[r]) == 1
    assert res.metrics["total_tokens"] == 5
    assert res.metrics["makespan_steps"] == res.requests[4]["finish"]


def test_serve_continuous_last_request_done_at_admission_after_others():
    """A trace of two-token requests whose last request is a one-token one,
    admitted when the ring has drained: the schedule ends with it."""
    seed = next(s for s in range(200)
                if list(serve.poisson_trace(4, 0.2, s, 2)[1]) == [2, 2, 2, 1])
    res = serve.serve_continuous("qwen2-0.5b", slots=4, n_requests=4,
                                 prompt_len=6, gen_len=2, arrival_rate=0.2,
                                 seed=seed, device="cpu", verbose=False)
    assert [len(res.tokens[r]) for r in range(4)] == [2, 2, 2, 1]
    last = res.requests[3]
    assert last["start"] == last["finish"]
    assert res.metrics["makespan_steps"] == max(
        rq["finish"] for rq in res.requests.values())


def _k6_case(B, d, V, v_real, greedy, seed):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(B, d)).astype(np.float32)
    table = (rng.normal(size=(V, d)) * 0.02).astype(np.float32)
    noise = np.zeros((B, V), np.float32) if greedy \
        else rng.gumbel(size=(B, V)).astype(np.float32)
    return y, table, noise


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "gumbel"])
@pytest.mark.parametrize("B,d,V,v_real", [(1, 2560, 4096, 4000),
                                          (4, 2560, 4096, 4096),
                                          (8, 8192, 2048, 2000)])
def test_k6_plain_takes_wide_heads(B, d, V, v_real, greedy):
    y, table, noise = _k6_case(B, d, V, v_real, greedy, seed=B + d)
    t = [torch.from_numpy(a) for a in (y, table, noise)]
    scale = d ** -0.5
    got = ops.decode_sample(*t, scale=scale, v_real=v_real)
    logits = ref.decode_sample_logits(*t, scale=scale, v_real=v_real)
    j = [jnp.asarray(a) for a in (y, table, noise)]
    for other in (jops.decode_sample(*j, scale=scale, v_real=v_real),
                  jref.decode_sample_ref(*j, scale=scale, v_real=v_real)):
        other = torch.from_numpy(np.asarray(other).copy())
        ties, bad = ref.near_tie_check(logits, other, got, v_real)
        assert bad == 0 and ties <= 1, (ties, bad)


def _smem(B, d, rows, ds_):
    """The shared memory ``decode_sample.cu``'s launch_blocks asks for."""
    return 4 * B * ds_ + 8 * ds._WARPS * B + (4 * rows * B if ds_ < d else 0)


@pytest.mark.parametrize("B,d,v_real", [(8, 896, 151936), (4, 2048, 50280),
                                        (32, 896, 151936)])
def test_k6_plan_keeps_one_pass_where_y_fits(B, d, v_real):
    """qwen2's and mamba2's heads keep the one-pass sum order they were
    measured with (ds = d, the first pass's grid unchanged)."""
    rows, nblocks, ds_ = ds.sample_plan(B, d, v_real)
    assert ds_ == d
    assert (rows, nblocks) == ds.sample_grid(v_real)
    assert _smem(B, d, rows, ds_) <= ds.SMEM_MAX


@pytest.mark.parametrize("B", [1, 4, 8, 64])
@pytest.mark.parametrize("d,v_real", [(2560, 262144), (2560, 151936),
                                      (2560, 32000), (8192, 102400),
                                      (896, 151936)])
def test_k6_plan_slices_d_where_y_does_not_fit(B, d, v_real):
    rows, nblocks, ds_ = ds.sample_plan(B, d, v_real)
    if d <= ds.SLICE_MAX and 4 * B * d + 8 * ds._WARPS * B <= ds.SMEM_MAX:
        assert ds_ == d
        return
    assert ds_ % 128 == 0 and 512 <= ds_ <= ds.SLICE_MAX and ds_ < d
    assert rows <= 256 and rows * nblocks >= v_real
    assert rows * (nblocks - 1) < v_real
    assert _smem(B, d, rows, ds_) <= ds.SMEM_MAX
