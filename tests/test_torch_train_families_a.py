"""``train.main`` of the port against the reference's for every family
beside qwen2-0.5b (``tests/test_torch_train.py``), on the fused loop:
savic, reduced configs, 2 rounds, M 2, H 2, b 1, the reference's weights
and round keys (``tests/_torch_train_families.py``). Loss at 1e-5
relative, drift at 1e-4 (a sum of squares of differences of nearly equal
params), as ``test_torch_train.py``. deepseek-v2 takes MLA through two
savic rounds; internvl2 runs at S 32, past its 16 reduced patches (at S
16 it keeps no text token: ``test_vlm_without_text_trains_on_nothing``)."""
import pytest

from _torch_train_families import hold, run_both


@pytest.mark.parametrize("arch,seq", [
    ("mamba2-1.3b", 16), ("qwen2-moe-a2.7b", 16), ("deepseek-v2-236b", 16),
    ("gemma3-4b", 16), ("musicgen-large", 16), ("internvl2-1b", 32)])
def test_savic_fused_matches_reference(arch, seq):
    got, want = run_both(arch, seq, ["--method", "savic"], fused=True)
    hold(got, want)
    assert all(r["loss"] > 0 and r["drift"] > 0 for r in got)


def test_vlm_without_text_trains_on_nothing():
    """internvl2 at S = P (16 reduced patches): ``_wrap_modal`` keeps
    ``tokens[..., :S - P]``, no token is labelled, and both packages log
    loss 0 and drift 0. A run must give S > P to train."""
    got, want = run_both("internvl2-1b", 16, ["--method", "savic"],
                         fused=True)
    hold(got, want)
    assert all(r["loss"] == 0.0 and r["drift"] == 0.0
               for r in got + want)
