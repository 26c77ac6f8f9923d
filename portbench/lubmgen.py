"""LUBM's university data, vectorised, made from a seed.

Follows the distributions of LUBM's data generator (UBA 1.7, the
`Generator` class of swat.cse.lehigh.edu/projects/lubm): per university
15-25 departments; per department 7-10 full, 10-14 associate and 8-11
assistant professors and 5-7 lecturers, 8-14 undergraduate and 3-4
graduate students per faculty member, 10-20 research groups; each faculty
member teaches 1-2 courses and 1-2 graduate courses and writes a number
of publications by rank; undergraduates take 2-4 courses and one in five
has a professor as advisor; graduate students take 1-3 graduate courses,
all have an advisor and an undergraduate degree from one of 1,000
universities, one in 4-5 is a teaching assistant of a course and one in
3-4 a research assistant. The terms are UBA's (`http://www.University0.edu`,
`http://www.Department3.University0.edu/FullProfessor2`, names, e-mail
addresses and the telephone literal).

Every `rdf:type` is closed under univ-bench.owl's class hierarchy (a full
professor is also a Professor, Faculty, Employee and Person; a graduate
student, by its definition, a Student), as a store without a reasoner
holds LUBM so that its queries have their published answers.

Whole-array NumPy draws replace UBA's loop per entity, so LUBM(100) is
made in seconds. The result is dictionary ids and the term list they
index, which the benchmark hands to the program and the reference alike.
"""
from __future__ import annotations

import dataclasses

import numpy as np

UB = "http://swat.cse.lehigh.edu/onto/univ-bench.owl#"
RDF_TYPE = "<http://www.w3.org/1999/02/22-rdf-syntax-ns#type>"
FACULTY = ("FullProfessor", "AssociateProfessor", "AssistantProfessor",
           "Lecturer")
# each emitted class with the superclasses univ-bench.owl gives it
SUPERS = {
    "University": ("Organization",),
    "Department": ("Organization",),
    "ResearchGroup": ("Organization",),
    "FullProfessor": ("Professor", "Faculty", "Employee", "Person"),
    "AssociateProfessor": ("Professor", "Faculty", "Employee", "Person"),
    "AssistantProfessor": ("Professor", "Faculty", "Employee", "Person"),
    "Lecturer": ("Faculty", "Employee", "Person"),
    "Chair": ("Professor", "Faculty", "Employee", "Person"),
    "UndergraduateStudent": ("Student", "Person"),
    "GraduateStudent": ("Student", "Person"),
    "TeachingAssistant": ("Person",),
    "ResearchAssistant": ("Person",),
    "Course": ("Work",),
    "GraduateCourse": ("Course", "Work"),
    "Publication": (),
}
CLASSES = tuple(dict.fromkeys(
    [c for k, v in SUPERS.items() for c in (k,) + v]))
PROPERTIES = (
    "name", "emailAddress", "telephone", "subOrganizationOf", "worksFor",
    "headOf", "memberOf", "undergraduateDegreeFrom", "mastersDegreeFrom",
    "doctoralDegreeFrom", "researchInterest", "teacherOf", "takesCourse",
    "advisor", "teachingAssistantOf", "publicationAuthor")
TELEPHONE = '"xxx-xxx-xxxx"'


@dataclasses.dataclass(frozen=True)
class Sizes:
    """UBA's distributions, each pair an inclusive [low, high]."""

    departments: tuple = (15, 25)
    full_professors: tuple = (7, 10)
    associate_professors: tuple = (10, 14)
    assistant_professors: tuple = (8, 11)
    lecturers: tuple = (5, 7)
    undergraduates_per_faculty: tuple = (8, 14)
    graduates_per_faculty: tuple = (3, 4)
    research_groups: tuple = (10, 20)
    courses_per_faculty: tuple = (1, 2)
    graduate_courses_per_faculty: tuple = (1, 2)
    courses_per_undergraduate: tuple = (2, 4)
    courses_per_graduate: tuple = (1, 3)
    undergraduates_per_advisee: int = 5
    graduates_per_teaching_assistant: tuple = (4, 5)
    graduates_per_research_assistant: tuple = (3, 4)
    publications_full_professor: tuple = (15, 20)
    publications_associate_professor: tuple = (10, 18)
    publications_assistant_professor: tuple = (5, 10)
    publications_lecturer: tuple = (0, 5)
    publications_per_graduate: tuple = (0, 5)
    degree_universities: int = 1000
    research_interests: int = 30

    @classmethod
    def from_config(cls, cfg: dict) -> "Sizes":
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in cfg["uba"].items()})


@dataclasses.dataclass
class Graph:
    """Encoded triples (n, 3) int32 and the terms their ids index."""

    triples: np.ndarray
    terms: list[str]


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(int(seed) & ((1 << 64) - 1))


def _draw(rng, pair, n) -> np.ndarray:
    lo, hi = pair
    return rng.integers(lo, hi + 1, n)


def _starts(counts: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)


def _owned(counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """For entities laid out owner by owner: each one's owner and its
    index within the owner."""
    owner = np.repeat(np.arange(len(counts)), counts)
    return owner, np.arange(int(counts.sum())) - _starts(counts)[owner]


def _distinct_draws(rng, high: np.ndarray, k: int) -> np.ndarray:
    """(len(high), k) distinct integers in [0, high) per row, uniform over
    ordered k-subsets: each draw skips the values already taken."""
    out = np.empty((len(high), k), np.int64)
    for j in range(k):
        v = rng.integers(0, high - j)
        taken = np.sort(out[:, :j], axis=1)
        for c in range(j):
            v = v + (v >= taken[:, c])
        out[:, j] = v
    return out


def _pick(rng, owner, counts, first, per_row) -> tuple[np.ndarray, np.ndarray]:
    """Each row takes `per_row[i]` distinct items of its owner's
    `counts[owner]`, which start at id `first[owner]`. Returns (row, item)
    pairs."""
    k = int(per_row.max()) if len(per_row) else 0
    if k == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    got = _distinct_draws(rng, counts[owner], k)
    keep = np.arange(k)[None, :] < per_row[:, None]
    rows = np.broadcast_to(np.arange(len(owner))[:, None], got.shape)[keep]
    return rows, (first[owner][:, None] + got)[keep]


def _rank_within(rng, owner) -> np.ndarray:
    """A uniformly random order of each owner's rows: row i's place."""
    key = rng.random(len(owner))
    order = np.lexsort((key, owner))
    counts = np.bincount(owner, minlength=int(owner.max()) + 1 if len(owner) else 0)
    place = np.empty(len(owner), np.int64)
    place[order] = np.arange(len(owner)) - _starts(counts)[owner[order]]
    return place


class _Terms:
    """The term list, built in blocks; `add` returns a block's first id."""

    def __init__(self):
        self.terms: list[str] = []

    def add(self, block: list[str]) -> int:
        first = len(self.terms)
        self.terms += block
        return first


def generate(universities: int, seed: int, sizes: Sizes = Sizes()) -> Graph:
    """LUBM(`universities`), drawn from `seed`."""
    rng = _rng(seed)
    n_u = int(universities)
    T = _Terms()
    cls = {c: T.add([f"<{UB}{c}>"]) for c in CLASSES}
    prop = {p: T.add([f"<{UB}{p}>"]) for p in PROPERTIES}
    rdf_type = T.add([RDF_TYPE])
    telephone = T.add([TELEPHONE])
    interests = T.add([f'"Research{i}"' for i in range(sizes.research_interests)])
    # the universities degrees come from include ones never generated
    n_pool = max(n_u, sizes.degree_universities)
    univ = T.add([f"<http://www.University{u}.edu>" for u in range(n_pool)])

    dept_per_u = _draw(rng, sizes.departments, n_u)
    d_univ, d_local = _owned(dept_per_u)
    n_d = len(d_univ)
    dept_path = [f"Department{d}.University{u}.edu"
                 for u, d in zip(d_univ.tolist(), d_local.tolist())]
    dept = T.add([f"<http://www.{p}>" for p in dept_path])

    # faculty, laid out department by department, rank by rank
    n_rank = np.stack([
        _draw(rng, getattr(sizes, f), n_d) for f in
        ("full_professors", "associate_professors", "assistant_professors",
         "lecturers")], 1)
    n_fac = n_rank.sum(1)
    n_prof = n_rank[:, :3].sum(1)
    f_dept, f_local = _owned(n_fac)
    rank_start = np.concatenate([np.zeros((n_d, 1), np.int64),
                                 np.cumsum(n_rank, 1)[:, :-1]], 1)
    f_rank = (f_local[:, None] >= rank_start[f_dept][:, 1:]).sum(1)
    f_index = f_local - rank_start[f_dept, f_rank]
    f_name = [f"{FACULTY[r]}{i}" for r, i in zip(f_rank.tolist(),
                                                 f_index.tolist())]
    f_uri = [f"http://www.{dept_path[d]}/{nm}"
             for d, nm in zip(f_dept.tolist(), f_name)]
    fac = T.add([f"<{x}>" for x in f_uri])
    f_start = _starts(n_fac)

    # students
    n_ug = n_fac * _draw(rng, sizes.undergraduates_per_faculty, n_d)
    n_gr = n_fac * _draw(rng, sizes.graduates_per_faculty, n_d)
    u_dept, u_local = _owned(n_ug)
    g_dept, g_local = _owned(n_gr)
    ug = T.add([f"<http://www.{dept_path[d]}/UndergraduateStudent{i}>"
                for d, i in zip(u_dept.tolist(), u_local.tolist())])
    gr = T.add([f"<http://www.{dept_path[d]}/GraduateStudent{i}>"
                for d, i in zip(g_dept.tolist(), g_local.tolist())])

    # courses: each faculty member's own, so a department's lie together
    def courses(pair, kind):
        per_f = _draw(rng, pair, len(f_dept))
        teacher = np.repeat(np.arange(len(f_dept)), per_f)
        per_d = np.bincount(f_dept, weights=per_f, minlength=n_d).astype(np.int64)
        c_dept, c_local = _owned(per_d)
        first = T.add([f"<http://www.{dept_path[d]}/{kind}{i}>"
                       for d, i in zip(c_dept.tolist(), c_local.tolist())])
        return first, teacher, c_dept, c_local, per_d

    crs, c_teacher, c_dept, c_local, n_crs = courses(
        sizes.courses_per_faculty, "Course")
    gcrs, gc_teacher, gc_dept, gc_local, n_gcrs = courses(
        sizes.graduate_courses_per_faculty, "GraduateCourse")

    n_rg = _draw(rng, sizes.research_groups, n_d)
    rg_dept, rg_local = _owned(n_rg)
    rgrp = T.add([f"<http://www.{dept_path[d]}/ResearchGroup{i}>"
                  for d, i in zip(rg_dept.tolist(), rg_local.tolist())])

    pub_pairs = [getattr(sizes, f"publications_{f}") for f in
                 ("full_professor", "associate_professor",
                  "assistant_professor", "lecturer")]
    lo = np.array([p[0] for p in pub_pairs])[f_rank]
    hi = np.array([p[1] for p in pub_pairs])[f_rank]
    n_pub_f = rng.integers(lo, hi + 1)
    p_fac, p_local = _owned(n_pub_f)
    pub = T.add([f"<{f_uri[f]}/Publication{i}>"
                 for f, i in zip(p_fac.tolist(), p_local.tolist())])
    n_pub_d = np.bincount(f_dept, weights=n_pub_f, minlength=n_d).astype(np.int64)
    pub_start_d = _starts(n_pub_d)  # a department's publications lie together

    # literals: names (shared between departments), e-mails (one each)
    def names(kind, n):
        return T.add([f'"{kind}{i}"' for i in range(int(n))])

    most = lambda x: int(x.max()) + 1 if len(x) else 0  # noqa: E731
    nm_univ = names("University", n_u)
    nm_dept = names("Department", most(d_local))
    nm_fac = {r: names(FACULTY[r], most(f_index[f_rank == r]))
              for r in range(4)}
    nm_ug = names("UndergraduateStudent", most(u_local))
    nm_gr = names("GraduateStudent", most(g_local))
    nm_crs = names("Course", most(c_local))
    nm_gcrs = names("GraduateCourse", most(gc_local))
    nm_pub = names("Publication", most(p_local))
    mail_f = T.add([f'"{nm}@{dept_path[d]}"'
                    for d, nm in zip(f_dept.tolist(), f_name)])
    mail_u = T.add([f'"UndergraduateStudent{i}@{dept_path[d]}"'
                    for d, i in zip(u_dept.tolist(), u_local.tolist())])
    mail_g = T.add([f'"GraduateStudent{i}@{dept_path[d]}"'
                    for d, i in zip(g_dept.tolist(), g_local.tolist())])

    blocks: list[np.ndarray] = []

    def emit(s, p, o):
        s = np.asarray(s, np.int64)
        blocks.append(np.stack([s, np.broadcast_to(np.int64(p), s.shape),
                                np.broadcast_to(np.asarray(o, np.int64),
                                                s.shape)], 1))

    def typed(s, c, role=False):
        """`c` and its superclasses; a role (chair, assistant) is taken by
        an entity that already has the role's superclasses."""
        for k in (c,) + (() if role else SUPERS[c]):
            emit(s, rdf_type, cls[k])

    uid = univ + np.arange(n_u)
    did = dept + np.arange(n_d)
    fid = fac + np.arange(len(f_dept))
    uids = ug + np.arange(len(u_dept))
    gids = gr + np.arange(len(g_dept))

    typed(uid, "University")
    emit(uid, prop["name"], nm_univ + np.arange(n_u))
    typed(did, "Department")
    emit(did, prop["name"], nm_dept + d_local)
    emit(did, prop["subOrganizationOf"], univ + d_univ)
    rgid = rgrp + np.arange(len(rg_dept))
    typed(rgid, "ResearchGroup")
    emit(rgid, prop["subOrganizationOf"], did[rg_dept])

    # faculty: the department's first full professor is its chair
    for r, c in enumerate(FACULTY):
        typed(fid[f_rank == r], c)
    chair = f_local == 0
    typed(fid[chair], "Chair", role=True)
    emit(fid[chair], prop["headOf"], did[f_dept[chair]])
    emit(fid[~chair], prop["worksFor"], did[f_dept[~chair]])
    nm_of_rank = np.array([nm_fac[r] for r in range(4)])
    emit(fid, prop["name"], nm_of_rank[f_rank] + f_index)
    emit(fid, prop["emailAddress"], mail_f + np.arange(len(f_dept)))
    emit(fid, prop["telephone"], telephone)
    for deg in ("undergraduateDegreeFrom", "mastersDegreeFrom",
                "doctoralDegreeFrom"):
        emit(fid, prop[deg], univ + rng.integers(0, n_pool, len(f_dept)))
    is_prof = f_rank < 3
    emit(fid[is_prof], prop["researchInterest"],
         interests + rng.integers(0, sizes.research_interests,
                                  int(is_prof.sum())))

    for first, teacher, c_d, c_l, kind in (
            (crs, c_teacher, c_dept, c_local, "Course"),
            (gcrs, gc_teacher, gc_dept, gc_local, "GraduateCourse")):
        cid = first + np.arange(len(teacher))
        typed(cid, kind)
        emit(cid, prop["name"], (nm_crs if kind == "Course" else nm_gcrs) + c_l)
        emit(fid[teacher], prop["teacherOf"], cid)

    pid = pub + np.arange(len(p_fac))
    typed(pid, "Publication")
    emit(pid, prop["name"], nm_pub + p_local)
    emit(pid, prop["publicationAuthor"], fid[p_fac])

    # undergraduates
    typed(uids, "UndergraduateStudent")
    emit(uids, prop["name"], nm_ug + u_local)
    emit(uids, prop["emailAddress"], mail_u + np.arange(len(u_dept)))
    emit(uids, prop["telephone"], telephone)
    emit(uids, prop["memberOf"], did[u_dept])
    row, item = _pick(rng, u_dept, n_crs, crs + _starts(n_crs),
                      _draw(rng, sizes.courses_per_undergraduate, len(u_dept)))
    emit(uids[row], prop["takesCourse"], item)
    advised = rng.integers(0, sizes.undergraduates_per_advisee,
                           len(u_dept)) == 0
    emit(uids[advised], prop["advisor"],
         fid[f_start[u_dept[advised]]
             + rng.integers(0, n_prof[u_dept[advised]])])

    # graduate students
    typed(gids, "GraduateStudent")
    emit(gids, prop["name"], nm_gr + g_local)
    emit(gids, prop["emailAddress"], mail_g + np.arange(len(g_dept)))
    emit(gids, prop["telephone"], telephone)
    emit(gids, prop["memberOf"], did[g_dept])
    emit(gids, prop["undergraduateDegreeFrom"],
         univ + rng.integers(0, n_pool, len(g_dept)))
    row, item = _pick(rng, g_dept, n_gcrs, gcrs + _starts(n_gcrs),
                      _draw(rng, sizes.courses_per_graduate, len(g_dept)))
    emit(gids[row], prop["takesCourse"], item)
    emit(gids, prop["advisor"],
         fid[f_start[g_dept] + rng.integers(0, n_prof[g_dept])])
    # assistants: a random order of each department's graduate students,
    # the first ones teaching assistants, the next research assistants
    n_ta = n_gr // _draw(rng, sizes.graduates_per_teaching_assistant, n_d)
    n_ra = n_gr // _draw(rng, sizes.graduates_per_research_assistant, n_d)
    place = _rank_within(rng, g_dept)
    ta = place < n_ta[g_dept]
    ra = ~ta & (place < (n_ta + n_ra)[g_dept])
    typed(gids[ta], "TeachingAssistant", role=True)
    # each assistant of another of the department's courses
    course_order = _rank_within(rng, c_dept)
    by_place = np.empty(len(c_dept), np.int64)
    by_place[_starts(n_crs)[c_dept] + course_order] = np.arange(len(c_dept))
    emit(gids[ta], prop["teachingAssistantOf"],
         crs + by_place[_starts(n_crs)[g_dept[ta]] + place[ta]])
    typed(gids[ra], "ResearchAssistant", role=True)
    row, item = _pick(rng, g_dept, n_pub_d, pub + pub_start_d,
                      _draw(rng, sizes.publications_per_graduate, len(g_dept)))
    emit(item, prop["publicationAuthor"], gids[row])

    return Graph(np.concatenate(blocks).astype(np.int32), T.terms)
