"""The vectorised generator: UBA's schema and distributions, the type
closure, LUBM's own answers in shape, and the same graph from the same
seed."""
import collections

import numpy as np
import pytest

from portbench import lubmgen

UB = lubmgen.UB


@pytest.fixture(scope="module")
def graph():
    return lubmgen.generate(3, 2**31 + 11)


def _decoded(graph):
    t = graph.triples
    terms = np.array(graph.terms, dtype=object)
    return terms[t[:, 0]], terms[t[:, 1]], terms[t[:, 2]]


def _ub(x):
    return f"<{UB}{x}>"


def _types(s, p, o):
    out = collections.defaultdict(set)
    for a, c in zip(s[p == lubmgen.RDF_TYPE], o[p == lubmgen.RDF_TYPE]):
        out[a].add(c[len(UB) + 1:-1])
    return out


def test_schema_and_terms(graph):
    s, p, o = _decoded(graph)
    assert set(p) == {lubmgen.RDF_TYPE} | {_ub(x) for x in lubmgen.PROPERTIES}
    assert set(o[p == lubmgen.RDF_TYPE]) == {_ub(c) for c in lubmgen.CLASSES}
    assert len(set(graph.terms)) == len(graph.terms)
    assert len(np.unique(graph.triples, axis=0)) == len(graph.triples)
    assert "<http://www.University0.edu>" in graph.terms
    assert ("<http://www.Department0.University0.edu/FullProfessor0>"
            in graph.terms)
    assert '"FullProfessor0@Department0.University0.edu"' in graph.terms


def test_every_type_is_closed_under_the_class_hierarchy(graph):
    types = _types(*_decoded(graph))
    for cs in types.values():
        for c in list(cs):
            assert set(lubmgen.SUPERS.get(c, ())) <= cs, (c, cs)


def test_per_department_distributions(graph):
    s, p, o = _decoded(graph)
    types = _types(s, p, o)
    sub = p == _ub("subOrganizationOf")
    depts = {a for a in s[sub] if "Department" in types[a]}
    per_u = collections.Counter(b for a, b in zip(s[sub], o[sub]) if a in depts)
    assert len(per_u) == 3 and all(15 <= n <= 25 for n in per_u.values())
    works = (p == _ub("worksFor")) | (p == _ub("headOf"))
    fac_dept = dict(zip(s[works], o[works]))
    member = p == _ub("memberOf")
    stud_dept = dict(zip(s[member], o[member]))
    ranges = {"FullProfessor": (7, 10), "AssociateProfessor": (10, 14),
              "AssistantProfessor": (8, 11), "Lecturer": (5, 7)}
    n_fac = collections.Counter(fac_dept.values())
    for rank, (lo, hi) in ranges.items():
        n = collections.Counter(d for f, d in fac_dept.items()
                                if rank in types[f])
        assert len(n) == len(depts) and lo <= min(n.values()) <= max(n.values()) <= hi
    assert set(n_fac) == depts
    heads = collections.Counter(o[p == _ub("headOf")])
    assert set(heads) == depts and set(heads.values()) == {1}
    for kind, (lo, hi) in (("UndergraduateStudent", (8, 14)),
                           ("GraduateStudent", (3, 4))):
        n = collections.Counter(d for x, d in stud_dept.items()
                                if kind in types[x])
        for d in depts:
            assert lo * n_fac[d] <= n[d] <= hi * n_fac[d]
    teach = p == _ub("teacherOf")
    per_teacher = collections.Counter(s[teach])
    assert set(per_teacher) == set(fac_dept)
    assert 2 <= min(per_teacher.values()) <= max(per_teacher.values()) <= 4
    course_dept = {c: fac_dept[t] for t, c in zip(s[teach], o[teach])}
    assert len(course_dept) == teach.sum()  # one teacher a course
    takes = p == _ub("takesCourse")
    pairs = list(zip(s[takes], o[takes]))
    assert len(set(pairs)) == len(pairs)
    assert all(course_dept[c] == stud_dept[x] for x, c in pairs)
    per_student = collections.Counter(s[takes])
    for x, n in per_student.items():
        ug = "UndergraduateStudent" in types[x]
        assert (2 <= n <= 4) if ug else (1 <= n <= 3)
    assert all(("GraduateCourse" in types[c])
               == ("GraduateStudent" in types[x]) for x, c in pairs)
    assert set(per_student) == set(stud_dept)
    adv = p == _ub("advisor")
    assert all(fac_dept[t] == stud_dept[x] and "Professor" in types[t]
               for x, t in zip(s[adv], o[adv]))
    grads = {x for x in stud_dept if "GraduateStudent" in types[x]}
    assert grads <= set(s[adv])
    n_ug = len(stud_dept) - len(grads)
    n_advised_ug = len(set(s[adv]) - grads)
    assert 0.15 < n_advised_ug / n_ug < 0.25
    deg = set(s[p == _ub("undergraduateDegreeFrom")])
    assert grads <= deg


def test_lubm_answers_have_their_published_shape():
    """Q9 answers some 14 rows a department (LUBM(1)'s 15 departments
    answer 208), Q2 about one graduate student in a thousand."""
    import json
    import pathlib

    from portbench import mix, reference

    g = lubmgen.generate(4, 3)
    data = reference.Triples(g.triples, g.terms)
    traffic = json.loads((pathlib.Path(__file__).resolve().parents[1]
                          / "traffic" / "analytic.json").read_text())
    got = {tp.name: len(reference.evaluate(data, list(tp.patterns),
                                           list(tp.select), tp.distinct))
           for tp in mix.templates(traffic)}
    s, p, o = _decoded(g)
    n_dept = int((o == _ub("Department")).sum())
    n_grad = int((o == _ub("GraduateStudent")).sum())
    assert 8 * n_dept < got["Q9"] < 20 * n_dept
    assert 0 < got["Q2"] < 4 * n_grad / 1000


def test_same_seed_same_graph_and_large_seeds():
    big = 2**31 + 12345
    a = lubmgen.generate(2, big)
    b = lubmgen.generate(2, big)
    c = lubmgen.generate(2, big + 1)
    assert np.array_equal(a.triples, b.triples) and a.terms == b.terms
    assert not np.array_equal(a.triples, c.triples) or a.terms != c.terms
