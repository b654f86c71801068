"""The paper's behavioural suite (§4.4, Tables 5-6) on the port, on the CPU.

On nfcorpus-like and scifact-like, built in this process (the generator's
seed holds ``hash(name)``, which Python randomises per process):

* the reference's ``benchmarks.behavioral.run()``, its ``DATASET_SPECS``
  cut to the one dataset, and the port's ``run()`` on the ``"reference"``
  engine print identical CSV rows;
* ``HopperBackend("cpu")`` (the kernels' plain versions) and
  ``TorchBackend("cpu")`` give each of the six plans the ids of
  ``fused-numpy`` on the same cache, but for adjacent swaps of scores
  within 1e-5, scores within 1e-5, and the Table 5/6 figures at the
  reference's printed precision.
"""

import pytest

torch = pytest.importorskip("torch")

import benchmarks.behavioral as RBH  # noqa: E402
from repro.data import beir as RBeir  # noqa: E402
from repro_torch.bench import behavioral as TBH  # noqa: E402
from repro_torch.core.backends import HopperBackend, TorchBackend  # noqa: E402

DATASETS = ["nfcorpus-like", "scifact-like"]
TOL = 1e-5
ENGINES = {"hopper": lambda: HopperBackend("cpu"),
           "torch": lambda: TorchBackend("cpu")}


@pytest.fixture(scope="module")
def suites():
    return {}


def _suite(suites, name):
    if name not in suites:
        suites[name] = TBH.setup(name)
    return suites[name]


@pytest.mark.parametrize("name", DATASETS)
def test_run_prints_the_reference_rows(name, monkeypatch, capsys):
    monkeypatch.setattr(RBH, "DATASET_SPECS",
                        {name: RBeir.DATASET_SPECS[name]})
    RBH.run()
    want = capsys.readouterr().out
    TBH.run("reference", [name])
    got = capsys.readouterr().out
    assert got == want
    assert len(got.splitlines()) == 6


def assert_same_ranking(got, want, tol=TOL):
    """Ids equal position by position, but for two neighbours whose
    oracle scores lie within ``tol`` trading places; scores within tol.
    Returns the swaps."""
    gi = [i for i, _ in got]
    wi = [i for i, _ in want]
    assert len(gi) == len(wi)
    swaps, p = 0, 0
    while p < len(gi):
        if gi[p] != wi[p]:
            assert (p + 1 < len(gi) and gi[p] == wi[p + 1]
                    and gi[p + 1] == wi[p]
                    and abs(want[p][1] - want[p + 1][1]) <= tol), (p, gi, wi)
            swaps += 1
            p += 1
        p += 1
    score = dict(want)
    assert max(abs(s - score[i]) for i, s in got) <= tol
    return swaps


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("name", DATASETS)
def test_port_engines_match_fused_numpy(name, engine, suites):
    suite = _suite(suites, name)
    want = TBH.run_dataset(name, "fused-numpy", suite=suite)
    got = TBH.run_dataset(name, ENGINES[engine](), suite=suite)
    assert got["searches"] == want["searches"] == 6 * TBH.N_QUERIES
    for plan in TBH.PLANS:
        assert len(got["rankings"][plan]) == TBH.N_QUERIES
        for g, w in zip(got["rankings"][plan], want["rankings"][plan]):
            assert len(g) == TBH.K
            assert_same_ranking(g, w)
    assert TBH.table5_rows(got) == TBH.table5_rows(want)
    assert TBH.table6_row(got) == TBH.table6_row(want)
