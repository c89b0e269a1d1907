"""Scenario 17's duplicates at its full-size stream (48 records, prompts
of 32, 32 new tokens) on the tiny model, on the CPU, by who served each
copy:

    python tests/procfleet_duplicates.py PACKAGE

PACKAGE is ``torchkafka_tpu`` or ``torchkafka_tpu_torch`` (the port's
workers serve on the CPU). Prints the scenario's duplicates and bound,
and a count of the duplicated records by their serving members in order:
a pair (survivor, survivor) is a record the survivor served twice itself.
Run from the repo root with the root on ``PYTHONPATH`` and
``OMP_NUM_THREADS=1``."""

import collections
import importlib
import sys


def main() -> None:
    pkg = sys.argv[1]
    scen = importlib.import_module(pkg + ".harness.scenarios")
    fleet_cls = importlib.import_module(pkg + ".fleet.supervisor").ProcessFleet
    kw = {}
    if pkg == "torchkafka_tpu":
        model = scen._serving_model
        scen._serving_model = lambda size, *a, **k: model("tiny", *a, **k)
    else:
        cfg = scen._default_cfg
        scen._default_cfg = lambda size, seq: cfg("tiny", seq)
        kw["device"] = "cpu"
    seen = {}
    results = fleet_cls.results

    def spy(self, isolation="read_uncommitted"):
        seen["res"] = results(self, isolation)
        return seen["res"]

    fleet_cls.results = spy
    r = scen.scenario_17("full", **kw)
    print({k: r[k] for k in ("records", "duplicates", "duplicate_bound", "victim")})
    print(collections.Counter(
        tuple(m for m, _ in copies) for copies in seen["res"].values() if len(copies) > 1))


if __name__ == "__main__":
    main()
