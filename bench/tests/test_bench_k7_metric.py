"""`k7_models_per_step` reads the program's ``k7.models`` counter over its
``rounds``: nothing where the program keeps no such counter (a program
before K7, or a CPU run, whose forwards take the plain version), and
the models a round where it does."""
from bench import harness


def _reader():
    return harness.find(harness.ROOT / "bench", "metrics",
                        "k7_models_per_step")


def test_reads_nothing_without_the_counter():
    from repro_torch import obs

    obs.reset()
    with obs.tracing():
        obs.count("rounds", 3)
    assert _reader().read(None) is None
    obs.reset()
    assert _reader().read(None) is None


def test_reads_the_models_a_round():
    from repro_torch import obs

    obs.reset()
    with obs.tracing():
        obs.count("rounds", 4)
        for _ in range(8):
            obs.count("k7.models", 20_025)
    assert _reader().read(None) == 40_050
    obs.reset()


def test_the_cell_reports_it():
    cell = harness.load_cell("papercnn-n100.dense")
    assert "k7_models_per_step" in [m["name"] for m in cell.per_layer]
