"""The traced run's reader on the card: a long window of tiny launches is
kept whole.  Needs an NVIDIA card with CUDA; skips elsewhere (decided in
the ``cuda`` fixture).

    python -m pytest -q -m gpu perfbench/tests/test_perfbench_trace_gpu.py
"""

import pytest

from harness import trace

pytestmark = pytest.mark.gpu

#: launches in the window: more device records than a 45 s window of the
#: composed SQL query holds at three times today's ~4,800 queries (31
#: device records a query, so ~465,000 at 15,000 queries)
LAUNCHES = 600_000


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA; run with -m gpu on one")
    return torch


def test_tracer_keeps_every_launch_of_a_long_window(cuda):
    """Both marker groups and every launch survive: ``read`` raises where
    the window lost an end, and each launch is counted in it."""
    torch = cuda
    x = torch.zeros(1, device="cuda")
    x.add_(1)
    torch.cuda.synchronize()
    tracer = trace.Tracer()
    with tracer:
        with tracer.window():
            for _ in range(LAUNCHES):
                x.add_(1)
    summary = tracer.read()
    assert summary["launches"] == {"vectorized_elementwise_kernel": LAUNCHES}
    assert 0 < summary["busy_s"] <= summary["window_s"]
    assert x.item() == LAUNCHES + 1
