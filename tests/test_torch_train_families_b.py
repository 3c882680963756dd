"""``train.main`` of the port against the reference's, continued
(``tests/test_torch_train_families_a.py``): an adaptive server (fedadam)
on the tree loop for one MoE and one modal family, and ``--dtype
bfloat16`` (bf16 compute; the params, momentum and D stay fp32 masters)
for a dense and the ssm family on the tree loop, and for the MoE family
on the fused loop, which fp32 state keeps (``chip_smoke.py``'s 17h).

bf16 tolerances: the two packages round the same activations to bf16 in
different orders of operations, so losses agree to 1e-3 relative (at most
1.8e-4 measured, mamba2's second round) and drifts to 1e-2 (at most
5.9e-3 measured: a difference of nearly equal params whose steps carry
the bf16 gradients)."""
import pytest

from _torch_train_families import hold, run_both


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "musicgen-large"])
def test_fedadam_tree_matches_reference(arch):
    got, want = run_both(arch, 16, ["--method", "fedadam"])
    hold(got, want)
    assert all("step_norm" in r for r in got)


@pytest.mark.parametrize("arch,fused", [
    ("qwen2-0.5b", False), ("mamba2-1.3b", False),
    ("qwen2-moe-a2.7b", True)])
def test_bf16_compute_matches_reference(arch, fused, capsys):
    got, want = run_both(arch, 16, ["--method", "savic", "--dtype",
                                    "bfloat16"], fused=fused)
    hold(got, want, loss_rtol=1e-3, drift_rtol=1e-2)
    # fp32 state: no fused_kernel_fallback, the fused loop stays
    assert "[train] tree loop:" not in capsys.readouterr().out
