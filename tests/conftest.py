import os
import sys
import tempfile

import pytest

# Tests must see the single real CPU device (the 512-device flag is scoped to
# the dry-run process only).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# Hermetic autotuner dispatch: never read a persistent cache — neither
# ~/.cache/repro/autotune.json nor a developer-exported REPRO_AUTOTUNE_CACHE.
# method="auto" must behave identically on every machine running the suite,
# so the variable is force-overridden to a fresh per-run temp path.
os.environ["REPRO_AUTOTUNE_CACHE"] = os.path.join(
    tempfile.mkdtemp(prefix="repro-autotune-"), "autotune.json"
)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


@pytest.fixture
def tconv_trace_counter(monkeypatch):
    """Counts how many times each LayerPlan is TRACED.

    ``repro.kernels.plan.execute_layer`` runs at trace time only — the plan
    is a static jit key, so a jit-cache hit never re-enters it. The fixture
    clears jax's compilation caches first (earlier tests may have warmed
    identical (plan, shapes) entries) and returns a ``{LayerPlan: count}``
    dict that fills as layers trace.
    """
    import jax

    from repro.kernels import plan as planlib

    jax.clear_caches()
    counts: dict = {}
    orig = planlib.execute_layer

    def spy(lp, x, kernel, **kw):
        counts[lp] = counts.get(lp, 0) + 1
        return orig(lp, x, kernel, **kw)

    monkeypatch.setattr(planlib, "execute_layer", spy)
    return counts


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips itself when none is present"
    )
