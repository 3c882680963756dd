"""The port's SSM family (reduced mamba2-1.3b) and K7's plain version held
against the reference: ``models/ssm.py`` function by function, the
intra-chunk term against the reference's Pallas kernel in interpret mode,
the kernel-route SSD (``ops.ssd``) against ``ssd_chunked``, and the model's
loss, gradients, logits and prefill cache. Inputs come from numpy seeds;
the reference's weights are carried across by ``repro_torch.bridge``.

Tolerances, and why. Let u = 2^-24 (half an fp32 ulp, relative). The SSD's
most order-sensitive step is cum = cumsum(dt·A) within a chunk: its terms
share one sign, so no partial sum exceeds max|cum| and each of the Q-1 adds
rounds by at most u·max|cum|. (The port accumulates cum in fp64 and rounds
once; the reference sums in fp32 in XLA's order.) Two implementations that
sum in other orders therefore differ in cum_i - cum_j by at most
4(Q-1)·u·max|cum|, which is
the relative error of every L_ij = exp(cum_i - cum_j), of the decays and of
the chunk totals. Each product adds at most (N + Q)·u relative and the
inter-chunk recurrence 2u per chunk, so every SSD output element is held to

    eps · M,   eps = u·(4(Q-1)·max|cum| + N + Q + 2·nc + 8),

where M is the same function of |x|, |B|, |C| (all its terms added as
magnitudes). max|cum| is measured on the inputs (A down to -16, as the
model's A_log = log(linspace(1, 16)) gives, makes it large). Elementwise
steps without a sum (the causal conv: K products) are held to
(K + 2)·u of their magnitude sums; fp32 projections to 1e-5 of their
largest value (the dense tests' tolerance). Model outputs (loss, logits,
gradients, caches) are held to eps·max|value|, with max|cum| taken over
every SSD call of the run: the norms and fp32 projections around the SSD
add ~d·u, far below eps. In bf16 (the model's default compute dtype) the
two frameworks round at different places: loss to 1e-2 relative, as the
dense tests, gradients to 5e-2 of each leaf's largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ssd_scan as jssd
from repro.models import ModelCallConfig as JCall
from repro.models import build as jbuild
from repro.models import ssm as JS
from repro.utils.tree import tree_paths as jtree_paths
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.engine import value_and_grad
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import ModelCallConfig, build
from repro_torch.models import ssm as S
from repro_torch.utils.tree import tree_paths

torch.set_num_threads(1)

ARCH = "mamba2-1.3b"
U = 2.0 ** -24


def eps_ssd(cum_max, Q, N, nc=1):
    """The SSD's relative bound (module docstring)."""
    return U * (4 * (Q - 1) * cum_max + N + Q + 2 * nc + 8)


def cum_max(dt, A, chunk):
    """max over cells of |cumsum(dt·A)| = the chunk sum of |dt·A|."""
    dt = np.asarray(dt, np.float64)
    B, Sq, H = dt.shape
    dA = np.abs(dt * np.asarray(A, np.float64)[None, None, :])
    return float(dA.reshape(B, Sq // chunk, chunk, H).sum(2).max())


def ssd_inputs(B, Sq, H, P, N, seed, a_min=None):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)); A = -exp(N(0, 1)) as in
    ``tests/test_kernels.py``, or evenly down to ``a_min`` (-16: the
    model's A_log range)."""
    r = np.random.default_rng(seed)
    f32 = np.float32
    x = r.normal(size=(B, Sq, H, P)).astype(f32)
    dt = np.logaddexp(r.normal(size=(B, Sq, H)), 0).astype(f32)
    if a_min is None:
        A = -np.exp(r.normal(size=(H,))).astype(f32)
    else:
        A = -np.linspace(1.0, -a_min, H).astype(f32)
    Bm = r.normal(size=(B, Sq, H, N)).astype(f32)
    Cm = r.normal(size=(B, Sq, H, N)).astype(f32)
    return x, dt, A, Bm, Cm


def t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def assert_within(got, want, bound, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    bound = np.asarray(bound, np.float64)
    err = np.abs(got - want)
    assert got.shape == want.shape, what
    assert np.all(err <= bound + 1e-30), \
        f"{what}: max err {err.max():.3e}, worst ratio " \
        f"{float((err / (bound + 1e-30)).max()):.3f}"


# --------------------------------------------------------------------------- #
# config and init
# --------------------------------------------------------------------------- #


def test_config_matches_reference():
    for reduced in (False, True):
        j, c = jget_config(ARCH, reduced=reduced), get_config(ARCH,
                                                             reduced=reduced)
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab_size", "tie_embeddings",
                  "norm_eps", "source", "is_attention_free"):
            assert getattr(c, f) == getattr(j, f), f
        for f in ("d_state", "d_conv", "expand", "head_dim", "chunk",
                  "ngroups"):
            assert getattr(c.ssm, f) == getattr(j.ssm, f), f
    for arch in ("musicgen-large", "internvl2-1b", "deepseek-v2-236b"):
        with pytest.raises(NotImplementedError, match="not ported"):
            get_config(arch)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_init_tree_matches_reference_layout(reduced):
    """The port's init has the reference's tree paths and shapes (its draws
    differ: a torch.Generator). Full width is read from the reference's
    abstract init only: 1,450,273,792 parameters."""
    jcfg, cfg = jget_config(ARCH, reduced=reduced), get_config(
        ARCH, reduced=reduced)
    jshape = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    want = [(p, tuple(x.shape)) for p, x in jtree_paths(jshape)]
    if not reduced:
        assert sum(int(np.prod(s)) for _, s in want) == 1_450_273_792
        cfg = cfg.replace(n_layers=1, d_model=256, vocab_size=512)
        jshape = jax.eval_shape(jbuild(jcfg.replace(
            n_layers=1, d_model=256, vocab_size=512)).init,
            jax.random.PRNGKey(0))
        want = [(p, tuple(x.shape)) for p, x in jtree_paths(jshape)]
    tp = build(cfg).init(torch.Generator().manual_seed(0))
    got = [(p, tuple(x.shape)) for p, x in tree_paths(tp)]
    assert got == want
    assert all(x.dtype == torch.float32 for _, x in tree_paths(tp))
    assert "norm2" not in tp["blocks"]["stack"]


# --------------------------------------------------------------------------- #
# models/ssm.py, function by function
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("Sq,K", [(16, 4), (2, 4), (7, 3)])
def test_causal_conv_and_tail_match_reference(Sq, K):
    r = np.random.default_rng(Sq)
    x = r.normal(size=(2, Sq, 24)).astype(np.float32)
    w = r.normal(size=(24, K)).astype(np.float32)
    want = np.asarray(JS._causal_conv(jnp.asarray(x), jnp.asarray(w)))
    got = S._causal_conv(*t(x, w)).numpy()
    mag = S._causal_conv(*t(np.abs(x), np.abs(w))).numpy()
    assert_within(got, want, (K + 2) * U * mag, "causal conv")
    tail = np.asarray(JS._conv_tail(jnp.asarray(x), K))
    np.testing.assert_array_equal(S._conv_tail(*t(x), K).numpy(), tail)


def test_conv_step_matches_reference():
    r = np.random.default_rng(3)
    state = r.normal(size=(3, 3, 20)).astype(np.float32)
    xt = r.normal(size=(3, 20)).astype(np.float32)
    w = r.normal(size=(20, 4)).astype(np.float32)
    wo, ws = JS._conv_step(jnp.asarray(state), jnp.asarray(xt),
                           jnp.asarray(w))
    go, gs = S._conv_step(*t(state, xt, w))
    mag, _ = S._conv_step(*t(np.abs(state), np.abs(xt), np.abs(w)))
    assert_within(go.numpy(), wo, 6 * U * mag.numpy(), "conv step")
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


SSD_SHAPES = [(1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32),
              (1, 256, 2, 64, 32, 64)]        # tests/test_kernels.py:93-97


def _ssd_bound(x, dt, A, Bm, Cm, chunk, h0=None):
    """Per-element bounds of y and h_final: eps times the magnitude run."""
    ta = t(np.abs(x), dt, A, np.abs(Bm), np.abs(Cm))
    h0a = None if h0 is None else torch.from_numpy(np.abs(h0))
    my, mh = S.ssd_chunked(*ta, chunk, h0=h0a)
    nc = x.shape[1] // chunk
    e = eps_ssd(cum_max(dt, A, chunk), chunk, Bm.shape[-1], nc)
    return e * my.numpy(), e * mh.numpy()


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("B,Sq,H,P,N,chunk", SSD_SHAPES)
def test_ssd_chunked_matches_reference(B, Sq, H, P, N, chunk, with_h0):
    x, dt, A, Bm, Cm = ssd_inputs(B, Sq, H, P, N, seed=Sq)
    h0 = np.random.default_rng(9).normal(size=(B, H, P, N)).astype(
        np.float32) if with_h0 else None
    wy, wh = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk,
                            h0=None if h0 is None else jnp.asarray(h0))
    gy, gh = S.ssd_chunked(*t(x, dt, A, Bm, Cm), chunk,
                           h0=None if h0 is None else torch.from_numpy(h0))
    by, bh = _ssd_bound(x, dt, A, Bm, Cm, chunk, h0)
    assert_within(gy.numpy(), wy, by, "y")
    assert_within(gh.numpy(), wh, bh, "h_final")


def test_ssd_chunked_matches_the_sequential_oracle():
    """``ssd_chunked`` against ``ssd_reference`` (one state update per
    token; its products add in another order: same bound)."""
    x, dt, A, Bm, Cm = ssd_inputs(2, 64, 3, 8, 8, seed=5)
    gy, gh = S.ssd_chunked(*t(x, dt, A, Bm, Cm), 16)
    wy, wh = ref.ssd_ref(*t(x, dt, A, Bm, Cm))
    jy, _ = JS.ssd_reference(*map(jnp.asarray, (x, dt, A, Bm, Cm)))
    by, bh = _ssd_bound(x, dt, A, Bm, Cm, 16)
    assert_within(gy.numpy(), wy.numpy(), by, "y vs oracle")
    assert_within(gh.numpy(), wh.numpy(), bh, "h vs oracle")
    assert_within(wy.numpy(), jy, by, "port oracle vs reference oracle")


def test_heads_view_has_head_stride_zero():
    cfg = get_config(ARCH, reduced=True)
    Bm = torch.randn(2, 5, cfg.ssm.d_state)
    v = S._heads(Bm, cfg.ssm, 8)
    assert v.shape == (2, 5, 8, cfg.ssm.d_state) and v.stride(2) == 0
    assert v.data_ptr() == Bm.data_ptr()


@pytest.fixture(scope="module")
def block():
    """Reduced mamba2's first block (reference init) and an input."""
    jcfg, cfg = jget_config(ARCH, reduced=True), get_config(ARCH,
                                                            reduced=True)
    jp = jax.device_get(JS.init_mamba2(jax.random.PRNGKey(3), jcfg))
    u = np.random.default_rng(4).normal(size=(2, 64, cfg.d_model)).astype(
        np.float32)
    return jcfg, cfg, jp, params_from_jax(jp, "cpu"), u


def _block_eps(cfg, jp, u):
    """eps of one block's SSD on input u: dt = softplus(u·wdt + dt_bias)."""
    dt = np.logaddexp(u.astype(np.float64) @ jp["wdt"]["w"] + jp["dt_bias"],
                      0)
    A = -np.exp(np.asarray(jp["A_log"], np.float64))
    Q = min(cfg.ssm.chunk, u.shape[1])
    return eps_ssd(cum_max(dt, A, Q), Q, cfg.ssm.d_state, u.shape[1] // Q)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "ssd_kernel"])
def test_mamba2_forward_and_cache_match_reference(block, kernel):
    """``mamba2_forward(return_cache=True)``: the output and h to eps of
    their largest values, the conv tails (fp32 projections) to 1e-5.
    ``ssd_kernel`` routes the SSD through ``ops.ssd`` (K7's plain version on
    the CPU)."""
    jcfg, cfg, jp, tp, u = block
    wo, wc = JS.mamba2_forward(jax.tree.map(jnp.asarray, jp), jcfg,
                               jnp.asarray(u), jnp.float32,
                               return_cache=True)
    with torch.no_grad():
        go, gc = S.mamba2_forward(tp, cfg, torch.from_numpy(u),
                                  torch.float32, return_cache=True,
                                  use_ssd_kernel=kernel)
    e = _block_eps(cfg, jp, u)
    wo = np.asarray(wo)
    assert_within(go.numpy(), wo, e * np.abs(wo).max(), "out")
    wh = np.asarray(wc["h"])
    assert_within(gc["h"].numpy(), wh, e * np.abs(wh).max(), "h")
    for key in ("conv_x", "conv_B", "conv_C"):
        w = np.asarray(wc[key])
        assert gc[key].dtype == torch.float32
        assert_within(gc[key].numpy(), w, 1e-5 * np.abs(w).max(), key)


def test_mamba2_h0_and_return_state_match_reference(block):
    """``h0`` continues from a given state (the first half's final state,
    ``return_state``) as the reference does; ``return_state`` and
    ``return_cache`` give the same final state."""
    jcfg, cfg, jp, tp, u = block
    e = _block_eps(cfg, jp, u)
    with torch.no_grad():
        _, h1 = S.mamba2_forward(tp, cfg, torch.from_numpy(u[:, :32]),
                                 torch.float32, return_state=True)
        _, c1 = S.mamba2_forward(tp, cfg, torch.from_numpy(u[:, :32]),
                                 torch.float32, return_cache=True)
        second = S.mamba2_forward(tp, cfg, torch.from_numpy(u[:, 32:]),
                                  torch.float32, h0=h1)
    assert torch.equal(h1, c1["h"]) and h1.shape == (2, 8, 32, 16)
    want = np.asarray(JS.mamba2_forward(
        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(u[:, 32:]),
        jnp.float32, h0=jnp.asarray(h1.numpy())))
    assert_within(second.numpy(), want, e * np.abs(want).max(), "h0 route")


def test_mamba2_decode_matches_reference(block):
    """Three decode steps from a random cache: outputs and state to 1e-5 of
    their largest values (a decode step has no cumsum: one exp, one mul and
    one add per state element; the fp32 projections set the tolerance), the
    state updated in place."""
    jcfg, cfg, jp, tp, u = block
    r = np.random.default_rng(6)
    jc = {k: r.normal(size=np.shape(v)).astype(np.float32)
          for k, v in JS.mamba2_init_cache(jcfg, 2).items()}
    tc = {k: torch.from_numpy(v.copy()) for k, v in jc.items()}
    jc = {k: jnp.asarray(v) for k, v in jc.items()}
    e = 1e-5
    for g in range(3):
        ut = u[:, g:g + 1]
        wo, jc = JS.mamba2_decode(jax.tree.map(jnp.asarray, jp), jcfg,
                                  jnp.asarray(ut), jc, jnp.float32)
        h_before = tc["h"]
        with torch.no_grad():
            go, tc2 = S.mamba2_decode(tp, cfg, torch.from_numpy(ut), tc,
                                      torch.float32)
        assert tc2 is tc and tc["h"] is h_before        # in place
        wo = np.asarray(wo)
        assert_within(go.numpy(), wo, e * np.abs(wo).max(), f"out {g}")
        for key in tc:
            w = np.asarray(jc[key])
            assert_within(tc[key].numpy(), w, e * np.abs(w).max(), key)


# --------------------------------------------------------------------------- #
# K7's plain version and the kernel-route SSD
# --------------------------------------------------------------------------- #


def _intra_bounds(x, dt, A, Bm, Cm, chunk):
    """Bounds of (Y_diag, S_chunk, total): eps times the magnitude run of
    the plain version."""
    my, ms, mt = ref.ssd_intra_chunk_ref(*t(np.abs(x), dt, A, np.abs(Bm),
                                            np.abs(Cm)), chunk)
    e = eps_ssd(cum_max(dt, A, chunk), chunk, Bm.shape[-1])
    return e * my.numpy(), e * ms.numpy(), e * mt.numpy()


@pytest.mark.parametrize("B,Sq,H,P,N,chunk,a_min", [
    *[(*s, None) for s in SSD_SHAPES],
    (1, 512, 2, 64, 128, 256, None),
    (1, 512, 4, 64, 128, 256, -16.0),
    (2, 128, 4, 32, 16, 32, -16.0),
])
def test_k7_plain_matches_interpret_mode_kernel(B, Sq, H, P, N, chunk,
                                                a_min):
    """``ref.ssd_intra_chunk_ref`` against the reference's Pallas kernel in
    interpret mode: Y_diag, S_chunk and total to eps of their magnitude
    sums (A down to -16 makes max|cum| reach hundreds to thousands)."""
    x, dt, A, Bm, Cm = ssd_inputs(B, Sq, H, P, N, seed=Sq + H, a_min=a_min)
    wy, ws, wt = jssd.ssd_intra_chunk(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                      chunk=chunk, interpret=True)
    gy, gs, gt = ref.ssd_intra_chunk_ref(*t(x, dt, A, Bm, Cm), chunk)
    by, bs, bt = _intra_bounds(x, dt, A, Bm, Cm, chunk)
    assert_within(gy.numpy(), wy, by, "Y_diag")
    assert_within(gs.numpy(), ws, bs, "S_chunk")
    assert_within(gt.numpy(), wt, bt, "total")
    if a_min is not None:
        assert cum_max(dt, A, chunk) > 400.0


def test_ssd_cumsum_is_the_rounded_fp64_sum():
    """K7's cum: each partial sum accumulated in fp64 in order and rounded
    once to fp32 (what the kernel does), at |cum| in the thousands."""
    d = -np.abs(np.random.default_rng(2).normal(size=(3, 256))).astype(
        np.float32) * 16
    got = ref.ssd_cumsum(torch.from_numpy(d)).numpy()
    want = np.cumsum(d.astype(np.float64), axis=-1).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and np.abs(got).max() > 2000


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("B,Sq,H,P,N,chunk", SSD_SHAPES)
def test_ssd_kernel_forward_matches_reference(B, Sq, H, P, N, chunk,
                                              with_h0):
    """``ops.ssd`` (K7's plain version, then the inter-chunk recurrence)
    against the reference's ``ssd_kernel_forward`` (interpret mode; it has
    no h0, so only from zeros) and against the port's ``ssd_chunked``."""
    x, dt, A, Bm, Cm = ssd_inputs(B, Sq, H, P, N, seed=Sq + 1)
    h0 = np.random.default_rng(8).normal(size=(B, H, P, N)).astype(
        np.float32) if with_h0 else None
    th0 = None if h0 is None else torch.from_numpy(h0)
    gy, gh = ops.ssd(*t(x, dt, A, Bm, Cm), chunk=chunk, h0=th0)
    py, ph = S.ssd_chunked(*t(x, dt, A, Bm, Cm), chunk, h0=th0)
    by, bh = _ssd_bound(x, dt, A, Bm, Cm, chunk, h0)
    assert_within(gy.numpy(), py.numpy(), by, "y vs ssd_chunked")
    assert_within(gh.numpy(), ph.numpy(), bh, "h vs ssd_chunked")
    if not with_h0:
        wy, wh = jssd.ssd_kernel_forward(*map(jnp.asarray,
                                              (x, dt, A, Bm, Cm)), chunk,
                                         interpret=True)
        assert_within(gy.numpy(), wy, by, "y vs reference")
        assert_within(gh.numpy(), wh, bh, "h vs reference")


def test_ssd_kernel_route_reads_head_stride_zero():
    """B and C as one group expanded over the heads (stride 0) give what
    contiguous copies give, bitwise (the same plain arithmetic)."""
    x, dt, A, Bm, Cm = ssd_inputs(2, 64, 4, 16, 8, seed=11)
    b1 = torch.from_numpy(Bm[:, :, :1]).expand(2, 64, 4, 8)
    c1 = torch.from_numpy(Cm[:, :, :1]).expand(2, 64, 4, 8)
    assert b1.stride(2) == 0
    y1, h1 = ops.ssd(*t(x, dt, A), b1, c1, chunk=16)
    y2, h2 = ops.ssd(*t(x, dt, A), b1.contiguous(), c1.contiguous(),
                     chunk=16)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def test_k7_wrapper_checks_its_arguments():
    """K7's contract (``check_args``, shared by the kernel's wrapper and
    ``ops.ssd`` on the CPU): shapes, fp32, Q <= 256 dividing S, N and P <=
    128, no grads; the kernel's wrapper refuses CPU tensors."""
    x, dt, A, Bm, Cm = t(*ssd_inputs(1, 64, 2, 16, 8, seed=1))
    ssd.check_args(x, dt, A, Bm, Cm, 16)
    bad = [((x, dt, A, Bm, Cm), 24, "dividing S"),
           ((x, dt, A, Bm, Cm), 512, "dividing S"),
           ((x.double(), dt, A, Bm, Cm), 16, "float32"),
           ((x, dt[:, :32], A, Bm, Cm), 16, "dt must be"),
           ((x, dt, A, Bm, Cm[..., :4]), 16, "Cm must be"),
           ((x, dt, A[:1], Bm, Cm), 16, "A must be"),
           ((x[0], dt, A, Bm, Cm), 16, "must be \\(B, S, H, P\\)")]
    for args, chunk, msg in bad:
        with pytest.raises(ValueError, match=msg):
            ops.ssd(*args, chunk=chunk)
    big = torch.zeros((1, 64, 2, 129))
    with pytest.raises(ValueError, match="P <= 128"):
        ops.ssd(big, dt, A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="N <= 128"):
        ops.ssd(x, dt, A, big, big, chunk=16)
    with pytest.raises(ValueError, match="forward-only"):
        ops.ssd(x.clone().requires_grad_(), dt, A, Bm, Cm, chunk=16)
    with pytest.raises(ValueError, match="forward-only"):
        ops.ssd(x, dt, A, Bm.clone().requires_grad_(), Cm, chunk=16)
    with pytest.raises(ValueError, match="launches on CUDA tensors"):
        ssd.ssd_intra_chunk(x, dt, A, Bm, Cm, 16)
    with pytest.raises(ValueError, match="no ssd for device"):
        ops.ssd(x.to("meta"), dt, A, Bm, Cm, chunk=16)


# --------------------------------------------------------------------------- #
# the model: loss, gradients, logits, prefill cache
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def model_setup():
    jcfg, cfg = jget_config(ARCH, reduced=True), get_config(ARCH,
                                                            reduced=True)
    jp = jax.device_get(jbuild(jcfg, JCall(dtype=jnp.float32)).init(
        jax.random.PRNGKey(0)))
    r = np.random.default_rng(0)
    toks = r.integers(0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    labs = r.integers(0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    labs[0, :3] = -1
    return jcfg, cfg, jp, toks, labs


def _batches(toks, labs):
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)},
            {"tokens": torch.from_numpy(toks).long(),
             "labels": torch.from_numpy(labs).long()})


class CumSpy:
    """Records max|cum| over every SSD call of the port's model (either
    route), for the model-level eps."""

    def __init__(self, monkeypatch):
        self.max, self.Q, self.N, self.nc = 0.0, 1, 1, 1
        for mod, name in ((S, "ssd_chunked"), (ops, "ssd")):
            monkeypatch.setattr(mod, name, self._wrap(getattr(mod, name)))

    def _wrap(self, fn):
        def spy(xh, dt, A, Bm, Cm, chunk, **kw):
            self.max = max(self.max, cum_max(dt.detach().float().numpy(),
                                             A.detach().numpy(), chunk))
            self.Q, self.N = chunk, Bm.shape[-1]
            self.nc = xh.shape[1] // chunk
            return fn(xh, dt, A, Bm, Cm, chunk=chunk, **kw)
        return spy

    @property
    def eps(self):
        return eps_ssd(self.max, self.Q, self.N, self.nc)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_reference_fp32(model_setup, monkeypatch,
                                             remat):
    jcfg, cfg, jp, toks, labs = model_setup
    spy = CumSpy(monkeypatch)
    jm = jbuild(jcfg, JCall(dtype=jnp.float32, remat=remat))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32, remat=remat))
    jb, tb = _batches(toks, labs)
    jl, jg = jax.value_and_grad(jm.loss)(jax.tree.map(jnp.asarray, jp), jb)
    tl, tg = value_and_grad(tm.loss)(params_from_jax(jp, "cpu"), tb)
    e = spy.eps
    assert spy.max > 100.0
    assert abs(float(tl) - float(jl)) <= e * abs(float(jl))
    jgrads = dict(jtree_paths(jax.device_get(jg)))
    for path, g in tree_paths(tg):
        w = np.asarray(jgrads[path])
        assert_within(g.numpy(), w, e * np.abs(w).max(), path)


def test_loss_and_grads_match_reference_bf16(model_setup):
    jcfg, cfg, jp, toks, labs = model_setup
    jm = jbuild(jcfg, JCall(dtype=jnp.bfloat16))
    tm = build(cfg, ModelCallConfig(dtype=torch.bfloat16))
    assert build(cfg).call.dtype == torch.bfloat16
    jb, tb = _batches(toks, labs)
    jl, jg = jax.value_and_grad(jm.loss)(jax.tree.map(jnp.asarray, jp), jb)
    tl, tg = value_and_grad(tm.loss)(params_from_jax(jp, "cpu"), tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-2)
    jgrads = dict(jtree_paths(jax.device_get(jg)))
    for path, g in tree_paths(tg):
        w = np.asarray(jgrads[path], np.float32)
        assert_within(g.float().numpy(), w, 5e-2 * np.abs(w).max(), path)


def test_logits_and_prefill_cache_match_reference(model_setup, monkeypatch):
    """``logits``, ``prefill`` and ``prefill_cache`` (the last logits, h and
    the conv tails of every layer) at eps of their largest values; the
    cache is fp32, ``{"mamba": {...}}`` with leaves stacked over L."""
    jcfg, cfg, jp, toks, labs = model_setup
    spy = CumSpy(monkeypatch)
    jm = jbuild(jcfg, JCall(dtype=jnp.float32))
    tm = build(cfg, ModelCallConfig(dtype=torch.float32))
    jb, tb = _batches(toks, labs)
    tp = params_from_jax(jp, "cpu")
    jpa = jax.tree.map(jnp.asarray, jp)
    with torch.inference_mode():
        lg = tm.logits(tp, tb)
        l0, raw = tm.prefill(tp, tb)
        l1, cache = tm.prefill_cache(tp, tb, 80)
    e = spy.eps
    want = np.asarray(jm.logits(jpa, jb))
    assert_within(lg.numpy(), want, e * np.abs(want).max(), "logits")
    jl, jc = jm.prefill_cache(jpa, jb, 80)
    jl = np.asarray(jl)
    assert_within(l1.numpy(), jl, e * np.abs(jl).max(), "last logits")
    assert torch.equal(l0, l1)
    assert set(cache) == {"mamba"} and set(raw) == {"stack"}
    for key, w in jc["mamba"].items():
        w = np.asarray(w)
        got = cache["mamba"][key]
        assert got.dtype == torch.float32 and got.shape[:2] == (
            cfg.n_layers, 2)
        tol = (1e-5 if key.startswith("conv") else e) * np.abs(w).max()
        assert_within(got.numpy(), w, tol, key)


def test_ssd_kernel_route_equals_plain_route_on_cpu(model_setup,
                                                    monkeypatch):
    """``use_ssd_kernel=True`` on the CPU (K7's plain version through
    ``ops.ssd``) gives the plain route's logits and cache to eps; ``loss``
    with it raises when differentiated (K7 is forward-only), and equals the
    plain loss without grad."""
    jcfg, cfg, jp, toks, labs = model_setup
    spy = CumSpy(monkeypatch)
    tp = params_from_jax(jp, "cpu")
    plain = build(cfg, ModelCallConfig(dtype=torch.float32))
    kern = build(cfg, ModelCallConfig(dtype=torch.float32,
                                      use_ssd_kernel=True))
    _, tb = _batches(toks, labs)
    with torch.inference_mode():
        lp, cp = plain.prefill_cache(tp, tb, 80)
        lk, ck = kern.prefill_cache(tp, tb, 80)
        lossp, lossk = plain.loss(tp, tb), kern.loss(tp, tb)
    e = spy.eps
    assert_within(lk.numpy(), lp.numpy(), e * float(lp.abs().max()),
                  "last logits")
    for key in cp["mamba"]:
        a, b = ck["mamba"][key], cp["mamba"][key]
        assert_within(a.numpy(), b.numpy(), e * float(b.abs().max()), key)
    assert abs(float(lossk) - float(lossp)) <= e * abs(float(lossp))
    with pytest.raises(ValueError, match="forward-only"):
        value_and_grad(kern.loss)(tp, tb)


def test_ssd_kernel_route_calls_ops_ssd_per_layer(model_setup, monkeypatch):
    jcfg, cfg, jp, toks, labs = model_setup
    calls = []
    real = ops.ssd

    def spy(*a, **kw):
        calls.append(kw["chunk"])
        return real(*a, **kw)

    monkeypatch.setattr(ops, "ssd", spy)
    kern = build(cfg, ModelCallConfig(dtype=torch.float32,
                                      use_ssd_kernel=True))
    _, tb = _batches(toks, labs)
    with torch.inference_mode():
        kern.prefill_cache(params_from_jax(jp, "cpu"), tb, 80)
        build(cfg, ModelCallConfig(dtype=torch.float32)).prefill_cache(
            params_from_jax(jp, "cpu"), tb, 80)
    assert calls == [cfg.ssm.chunk] * cfg.n_layers
