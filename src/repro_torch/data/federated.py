"""Systems-heterogeneity models used by the training CLI (numpy copy of the
parts of ``repro/data/federated.py`` that ``launch/train.py`` calls)."""
from __future__ import annotations

import numpy as np

SYSTEMS_MODELS = ("uniform", "lognormal", "tiers")


def sample_step_times(model: str, n_clients: int, seed: int = 0, *,
                      sigma: float = 0.6,
                      tiers=(1.0, 2.0, 4.0), tier_probs=None) -> np.ndarray:
    """Per-client RELATIVE step times under a systems-heterogeneity model
    from SYSTEMS_MODELS. uniform/lognormal normalize so the fastest DRAWN
    client is 1.0; tiers normalizes by the declared fastest tier."""
    rng = np.random.default_rng(seed)
    if model == "uniform":
        return np.ones(n_clients)
    if model == "lognormal":
        t = rng.lognormal(mean=0.0, sigma=sigma, size=n_clients)
        return t / t.min()
    if model == "tiers":
        tiers = np.asarray(tiers, dtype=np.float64)
        if tier_probs is None:
            tier_probs = np.full(len(tiers), 1.0 / len(tiers))
        t = rng.choice(tiers, size=n_clients, p=np.asarray(tier_probs))
        return t / tiers.min()
    raise ValueError(f"systems model {model!r}; expected one of "
                     f"{SYSTEMS_MODELS}")


def simulated_round_time(step_times: np.ndarray, local_steps, *,
                         barrier: str = "sync",
                         buffer_rounds: int = 0) -> float:
    """Simulated wall-clock per round (relative units).

    sync   the server waits for every client: max_m(t_m · H_m).
    async  a delta may land up to B rounds late: max_m(t_m · H_m) / B.
    """
    step_times = np.asarray(step_times, dtype=np.float64)
    h_m = np.asarray(local_steps, dtype=np.float64)
    slowest = float((step_times * h_m).max())
    if barrier == "sync":
        return slowest
    if barrier == "async":
        return slowest / max(int(buffer_rounds), 1)
    raise ValueError(f"barrier {barrier!r}; expected 'sync' or 'async'")
