"""LUBM-style benchmark data + the 5 evaluation queries (paper §3).

The real LUBM generator emits a university-domain ontology; we reproduce
its structural skeleton (universities → departments → professors/students/
courses with typed relations) at an arbitrary scale factor, so join
selectivities behave like the benchmark: type scans are wide, relation
scans are narrow, multi-pattern BGPs have 1:N and N:M joins.

Five queries in the spirit of LUBM Q1/Q2/Q4/Q7/Q9 — star and chain BGPs of
2–5 triple patterns over the generated schema (the paper does not list its
exact 5; these cover the shape classes its Table 2 spans).
"""
from __future__ import annotations

import numpy as np

from repro_torch.sparql.dictionary import TermDict
from repro_torch.sparql.store import TripleStore

UB = "http://swat.cse.lehigh.edu/onto/univ-bench.owl#"
RDF_TYPE = "<http://www.w3.org/1999/02/22-rdf-syntax-ns#type>"


def _e(name: str) -> str:  # entity IRI
    return f"<http://example.org/{name}>"


def _u(name: str) -> str:  # ontology IRI
    return f"<{UB}{name}>"


def join_shape_triples() -> list[tuple[str, str, str]]:
    """The J1/J2 bad-join-order subgraphs (deterministic).

    Both are chains whose *smallest* pattern is the wrong place to start:
    the greedy planner (leaf cardinality only) begins at the 10-row type
    scan, whose only connection is a 1:50/1:60 fan-out edge — a 500/600 row
    intermediate — while the statistics-driven order starts from the
    selective tail and keeps every intermediate at ~a dozen rows. The gap
    between the two orders' maximum join buckets is what
    benchmarks/bench_query.py and tests/test_optimizer.py measure.
    """
    out: list[tuple[str, str, str]] = []
    t = out.append
    # J1: jtype (10) -- j1 fan-out (500) -- j2 selective tail (12)
    for i in range(10):
        t((_e(f"J/x{i}"), _e("J/jtype"), _e("J/JT")))
        for k in range(50):
            t((_e(f"J/x{i}"), _e("J/j1"), _e(f"J/y{i * 50 + k}")))
    for n, yi in enumerate([i * 50 for i in range(10)] + [1, 2]):
        t((_e(f"J/y{yi}"), _e("J/j2"), _e(f"J/z{n}")))
    # J2: ktype (10) -- k1 fan-out (600) -- k2 (20) -- k3 tail (15)
    for i in range(10):
        t((_e(f"J/a{i}"), _e("J/ktype"), _e("J/KT")))
        for k in range(60):
            t((_e(f"J/a{i}"), _e("J/k1"), _e(f"J/b{i * 60 + k}")))
    for n, bi in enumerate([i * 60 for i in range(10)] + list(range(1, 11))):
        t((_e(f"J/b{bi}"), _e("J/k2"), _e(f"J/c{n}")))
    for n in range(15):
        t((_e(f"J/c{n}"), _e("J/k3"), _e(f"J/d{n}")))
    return out


def skewed_shape_triples() -> list[tuple[str, str, str]]:
    """The S1 skewed-predicate subgraph (deterministic).

    A 2-hop chain `?x p1 ?y . ?y p2 ?z` engineered so the join key is
    dominated by ONE hot value: p1 has 500 edges into a single hot object
    plus 100 degree-1 objects (o_skew ≈ 84), and p2 hangs 40 edges off
    that hot subject plus 20 degree-1 subjects. The join output (~20k
    rows) is within a constant factor of the dense |L|·|R| compare grid,
    which is exactly where the matrix (masked-SpMM) backend's
    argsort-free pipeline beats the MR join — the optimizer must pick it
    from σ·skew alone (see sparql/optimizer._choose_backend).
    """
    out: list[tuple[str, str, str]] = []
    t = out.append
    hot = _e("S/hub")
    for i in range(500):
        t((_e(f"S/x{i}"), _e("S/p1"), hot))
    for i in range(100):
        t((_e(f"S/u{i}"), _e("S/p1"), _e(f"S/v{i}")))
    for k in range(40):
        t((hot, _e("S/p2"), _e(f"S/z{k}")))
    for i in range(20):
        t((_e(f"S/w{i}"), _e("S/p2"), _e(f"S/q{i}")))
    return out


def generate(
    scale: int = 1,
    seed: int = 0,
    join_shapes: bool = False,
    skew_shapes: bool = False,
):
    """~scale × (15 departments × ~70 people) university graph.

    `join_shapes=True` additionally embeds the J1/J2 bad-join-order
    subgraphs (`join_shape_triples`) used to benchmark the optimizer;
    `skew_shapes=True` embeds the S1 skewed-predicate subgraph
    (`skewed_shape_triples`) used to benchmark backend selection."""
    rng = np.random.default_rng(seed)
    triples: list[tuple[str, str, str]] = []
    t = triples.append
    if join_shapes:
        triples.extend(join_shape_triples())
    if skew_shapes:
        triples.extend(skewed_shape_triples())
    for ui in range(scale):
        uni = _e(f"University{ui}")
        t((uni, RDF_TYPE, _u("University")))
        for di in range(15):
            dept = _e(f"Dept{ui}_{di}")
            t((dept, RDF_TYPE, _u("Department")))
            t((dept, _u("subOrganizationOf"), uni))
            n_prof = 7 + int(rng.integers(0, 5))
            profs = []
            for pi in range(n_prof):
                prof = _e(f"Prof{ui}_{di}_{pi}")
                profs.append(prof)
                t((prof, RDF_TYPE, _u("FullProfessor")))
                t((prof, _u("worksFor"), dept))
                t((prof, _u("name"), f'"prof_{ui}_{di}_{pi}"'))
                deg = _e(f"University{int(rng.integers(0, max(1, scale)))}")
                t((prof, _u("undergraduateDegreeFrom"), deg))
            n_course = 12 + int(rng.integers(0, 6))
            courses = []
            for ci in range(n_course):
                c = _e(f"Course{ui}_{di}_{ci}")
                courses.append(c)
                t((c, RDF_TYPE, _u("Course")))
                teacher = profs[int(rng.integers(0, n_prof))]
                t((teacher, _u("teacherOf"), c))
            for si in range(40 + int(rng.integers(0, 20))):
                s = _e(f"Student{ui}_{di}_{si}")
                t((s, RDF_TYPE, _u("GraduateStudent")))
                t((s, _u("memberOf"), dept))
                t((s, _u("advisor"), profs[int(rng.integers(0, n_prof))]))
                for c in rng.choice(n_course, size=min(3, n_course),
                                    replace=False):
                    t((s, _u("takesCourse"), courses[int(c)]))
    d = TermDict()
    enc = np.array(
        [[d.encode(a), d.encode(b), d.encode(c)] for a, b, c in triples],
        np.int32,
    )
    return TripleStore(enc, d)


PREFIX = f"PREFIX ub: <{UB}>\nPREFIX rdf: <http://www.w3.org/1999/02/22-rdf-syntax-ns#>\n"

QUERIES: dict[str, str] = {
    # Q1 (LUBM-1-like): students taking a specific course — selective 2-join
    "Q1": PREFIX + """SELECT ?x WHERE {
        ?x rdf:type ub:GraduateStudent .
        ?x ub:takesCourse <http://example.org/Course0_0_0> .
    }""",
    # Q2 (chain): student -> advisor -> department (3 patterns, chain join)
    "Q2": PREFIX + """SELECT ?s ?p ?d WHERE {
        ?s ub:advisor ?p .
        ?p ub:worksFor ?d .
        ?d ub:subOrganizationOf <http://example.org/University0> .
    }""",
    # Q4 (star): professor attributes within a department
    "Q4": PREFIX + """SELECT ?p ?n WHERE {
        ?p rdf:type ub:FullProfessor .
        ?p ub:worksFor <http://example.org/Dept0_0> .
        ?p ub:name ?n .
    }""",
    # Q7 (N:M): students of courses taught by a given professor
    "Q7": PREFIX + """SELECT ?s ?c WHERE {
        ?s ub:takesCourse ?c .
        <http://example.org/Prof0_0_0> ub:teacherOf ?c .
        ?s rdf:type ub:GraduateStudent .
    }""",
    # Q9 (triangle-ish, 5 patterns): classmate pairs sharing advisor's course
    "Q9": PREFIX + """SELECT ?s ?t ?c WHERE {
        ?s ub:advisor ?t .
        ?t ub:teacherOf ?c .
        ?s ub:takesCourse ?c .
        ?s rdf:type ub:GraduateStudent .
        ?t rdf:type ub:FullProfessor .
    }""",
}

# Bad-join-order shapes over the join_shape_triples() subgraphs: the greedy
# order explodes the first intermediate (500/600 rows), the statistics
# order stays ~12/15 rows. Only valid on generate(..., join_shapes=True).
J_QUERIES: dict[str, str] = {
    "J1": """SELECT ?x ?y ?z WHERE {
        ?x <http://example.org/J/jtype> <http://example.org/J/JT> .
        ?x <http://example.org/J/j1> ?y .
        ?y <http://example.org/J/j2> ?z .
    }""",
    "J2": """SELECT ?a ?b ?c ?d WHERE {
        ?a <http://example.org/J/ktype> <http://example.org/J/KT> .
        ?a <http://example.org/J/k1> ?b .
        ?b <http://example.org/J/k2> ?c .
        ?c <http://example.org/J/k3> ?d .
    }""",
}

# Skewed-predicate shape over skewed_shape_triples(): a hot join key puts
# the output within a constant factor of the dense |L|·|R| grid, so the
# cost model (selectivity × skew) routes the join to the matrix backend.
# Only valid on generate(..., skew_shapes=True).
S_QUERIES: dict[str, str] = {
    "S1": """SELECT ?x ?y ?z WHERE {
        ?x <http://example.org/S/p1> ?y .
        ?y <http://example.org/S/p2> ?z .
    }""",
}

# Operator-coverage shapes (the same four as benchmarks/bench_query.py's
# EXTRA_QUERIES): device-side FILTER masks, an OPTIONAL left join with
# UNBOUND padding, a LIMIT slice, and a UNION concat. Valid on any
# generate() store.
OPERATOR_QUERIES: dict[str, str] = {
    # F1: star BGP + string-identity filter
    "F1": PREFIX + """SELECT ?p ?n WHERE {
        ?p a ub:FullProfessor .
        ?p ub:name ?n .
        FILTER (?n != "prof_0_0_0")
    }""",
    # O1: wide type scan, optional advisor edge (some students unmatched)
    "O1": PREFIX + """SELECT ?s ?a WHERE {
        ?s a ub:GraduateStudent .
        OPTIONAL { ?s ub:advisor ?a }
    }""",
    # FO1: filter + optional + limit through one compiled program
    "FO1": PREFIX + """SELECT ?s ?d ?a WHERE {
        ?s ub:memberOf ?d .
        OPTIONAL { ?s ub:advisor ?a }
        FILTER (?s != ?a)
    } LIMIT 64""",
    # U1: shared required scan, two union branches, one compiled dispatch
    "U1": PREFIX + """SELECT ?s ?v WHERE {
        ?s a ub:GraduateStudent .
        { ?s ub:advisor ?v } UNION { ?s ub:memberOf ?v }
    }""",
}
