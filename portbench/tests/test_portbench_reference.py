"""The plain reference against the port's CPU engine on every template,
and against a nested-loop evaluation of random patterns."""
import collections
import itertools
import json
import pathlib

import numpy as np
import pytest

from portbench import lubmgen, mix, reference
from repro_torch.sparql.dictionary import TermDict
from repro_torch.sparql.engine import QueryEngine, ShardedQueryEngine
from repro_torch.sparql.sharded_store import ShardedTripleStore
from repro_torch.sparql.store import TripleStore

PB = pathlib.Path(__file__).resolve().parents[1]
MIXES = sorted(p.stem for p in (PB / "traffic").glob("*.json"))


@pytest.fixture(scope="module")
def graph():
    return lubmgen.generate(2, 20240611)


@pytest.fixture(scope="module")
def engines(graph):
    d = TermDict()
    for t in graph.terms:
        d.encode(t)
    return {
        "single": QueryEngine(TripleStore.from_arrays(graph.triples,
                                                      graph.terms),
                              device="cpu"),
        "shard4": ShardedQueryEngine(
            ShardedTripleStore(graph.triples, d, 4), device="cpu"),
    }


@pytest.mark.parametrize("layout", ["single", "shard4"])
@pytest.mark.parametrize("mix_name", MIXES)
def test_reference_equals_the_port_on_every_template(graph, engines, layout,
                                                     mix_name):
    traffic = json.loads((PB / "traffic" / f"{mix_name}.json").read_text())
    data = reference.Triples(graph.triples, graph.terms)
    eng = engines[layout]
    for tp in mix.templates(traffic):
        ids = reference.evaluate(data, list(tp.patterns), list(tp.select),
                                 tp.distinct)
        want = collections.Counter(tuple(graph.terms[i] for i in row)
                                   for row in ids.tolist())
        got = collections.Counter(tuple(r[v] for v in tp.select)
                                  for r in eng.prepare(tp.text).run().rows)
        assert got == want, tp.name
        assert len(want) > 1, tp.name


def _nested_loop(triples, patterns, select, distinct):
    rows = [{}]
    for pat in patterns:
        nxt = []
        for b in rows:
            for t in triples:
                env = dict(b)
                ok = True
                for term, val in zip(pat, t):
                    if term.startswith("?"):
                        if env.setdefault(term, val) != val:
                            ok = False
                    elif term != val:
                        ok = False
                if ok:
                    nxt.append(env)
        rows = nxt
    out = [tuple(b[v] for v in select) for b in rows]
    return sorted(set(out)) if distinct else sorted(out)


@pytest.mark.parametrize("seed", range(6))
def test_reference_equals_a_nested_loop(seed):
    rng = np.random.default_rng(seed)
    terms = [f"<t{i}>" for i in range(7)]
    triples = rng.integers(0, 7, (40, 3)).astype(np.int32)
    data = reference.Triples(triples, terms)
    named = [tuple(terms[i] for i in t) for t in triples.tolist()]
    shapes = [
        [("?a", "<t1>", "?b"), ("?b", "<t2>", "?c")],
        [("?a", "?p", "?b"), ("?b", "?p", "?a")],
        [("?a", "<t1>", "?b"), ("?a", "<t2>", "?c"), ("?c", "<t3>", "?b")],
        [("?a", "<t0>", "?a"), ("?a", "?q", "?d")],
        [("?a", "<t4>", "<t5>"), ("?b", "<t6>", "?c")],
    ]
    for pats, (distinct, sel) in itertools.product(
            shapes, [(True, ["?a"]), (False, ["?a"]), (True, None)]):
        select = sel or sorted({v for p in pats for v in p if v[0] == "?"})
        got = reference.evaluate(data, pats, select, distinct)
        got = sorted(tuple(terms[i] for i in row) for row in got.tolist())
        assert got == _nested_loop(named, pats, select, distinct), pats


@pytest.mark.parametrize("mix_name", MIXES)
def test_packed_keys_change_some_answer(mix_name):
    """The control's answers differ from the reference's on some template
    of every mix once ids pass 2^16."""
    g = lubmgen.generate(10, 5)
    data = reference.Triples(g.triples, g.terms)
    traffic = json.loads((PB / "traffic" / f"{mix_name}.json").read_text())
    extra = 0
    for tp in mix.templates(traffic):
        args = (data, list(tp.patterns), list(tp.select), tp.distinct)
        exact = reference.evaluate(*args)
        packed = reference.evaluate(*args, packed16=True)
        assert not ({tuple(r) for r in exact.tolist()}
                    - {tuple(r) for r in packed.tolist()})
        extra += len(packed) - len(exact)
    assert extra > 0


@pytest.mark.parametrize("seed", range(3))
def test_packed_keys_equal_exact_keys_below_two_to_the_sixteen(seed):
    rng = np.random.default_rng(seed)
    terms = [f"<t{i}>" for i in range(9)]
    triples = rng.integers(0, 9, (60, 3)).astype(np.int32)
    data = reference.Triples(triples, terms)
    pats = [("?a", "<t1>", "?b"), ("?a", "<t2>", "?c"), ("?c", "<t3>", "?b")]
    select = ["?a", "?b", "?c"]
    assert np.array_equal(
        reference.evaluate(data, pats, select, False),
        reference.evaluate(data, pats, select, False, packed16=True))
