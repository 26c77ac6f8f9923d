"""The control and the planted faults that the comparison has to catch.

The control puts the reference in the program's place one step below the
int32 ids the configurations state: a join on two or more variables (the
join that closes each of LUBM's triangles) compares one 32-bit key
packed from each id's low 16 bits, the step that would tempt a program
to sort one key instead of two. The faults break the
program's timed path underneath an otherwise whole run (tests):

  altered_answer      the first row of every answer names another term
  half_batch_dropped  the odd lanes of every stacked dispatch answer nothing
  exchange_left_out   the sharded program's all-to-all keeps every row home
  stale_answer        every request gets the answer of the request before

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 2

runs the control on each seed at the cell's own size and prints each
seed's readings of the numbers compared, one JSON object a line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys
import threading


@dataclasses.dataclass
class Answer:
    rows: list
    vars: tuple


def packed16_stand_in(graph, templates):
    """The control: text -> the reference's rows with packed 16-bit keys,
    one answer object shared by every request of a template."""
    from portbench import reference

    data = reference.Triples(graph.triples, graph.terms)
    terms = graph.terms
    answers = {}
    for tp in templates:
        ids = reference.evaluate(data, list(tp.patterns), list(tp.select),
                                 tp.distinct, packed16=True)
        rows = [dict(zip(tp.select, (terms[i] for i in row)))
                for row in ids.tolist()]
        answers[tp.text] = Answer(rows, tp.select)
    return answers.__getitem__


@contextlib.contextmanager
def _patched(owner, name, make):
    old = getattr(owner, name)
    setattr(owner, name, make(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


def altered_answer():
    from repro_torch.sparql.engine import QueryEngine

    def make(old):
        def decode(self, schema, rows):
            out = old(self, schema, rows)
            if out:
                v = next(iter(out[0]))
                out[0] = dict(out[0], **{v: self.store.dictionary.decode(0)})
            return out
        return decode
    return _patched(QueryEngine, "_decode_numpy", make)


def half_batch_dropped():
    from repro_torch.sparql.engine import PendingDecode

    def make(old):
        def resolve(self):
            rs = old(self)
            if self.lane is not None and self.lane % 2 == 1:
                rs.rows = []
            return rs
        return resolve
    return _patched(PendingDecode, "resolve", make)


def exchange_left_out():
    from repro_torch.core import distributed

    return _patched(distributed, "all_to_all",
                    lambda old: lambda buf, mesh, axis: buf)


def stale_answer():
    from repro_torch.serve.batcher import MicroBatcher

    last = {}
    lock = threading.Lock()

    def make(old):
        def submit(self, payload, timeout=30.0, trace=None):
            res = old(self, payload, timeout, trace)
            with lock:
                prev = last.get("res", res)
                last["res"] = res
            return prev
        return submit
    return _patched(MicroBatcher, "submit", make)


FAULTS = {
    "altered_answer": altered_answer,
    "half_batch_dropped": half_batch_dropped,
    "exchange_left_out": exchange_left_out,
    "stale_answer": stale_answer,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control, on several seeds")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path[:] = [p for p in sys.path
                   if pathlib.Path(p or ".").resolve() != root / "portbench"]
    sys.path.insert(0, str(root))
    from portbench import harness
    from portbench.catalog import find_cell

    cell = find_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = harness.run(cell, seed, args.seconds, trace=False,
                          device="cpu", stand_in=packed16_stand_in)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
