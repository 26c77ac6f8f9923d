"""The port's engine (device="cpu") returns the reference engine's rows, in
order, with the optimizer's per-join backend choice — and against the
reference engine run on its Pallas kernels (interpret mode).

Also the shared cases of the other test_torch_engine_* files: both
engines get identical data (the reference generates the LUBM store, the
port's store is built from its triples and term list); JAX stays on the
CPU and the port runs with device="cpu"."""
import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import torch  # noqa: F401
import pytest

from repro.sparql import lubm as j_lubm
from repro.sparql.engine import QueryEngine as JEngine
from repro_torch.sparql import lubm as t_lubm
from repro_torch.sparql.engine import QueryEngine as TEngine
from repro_torch.sparql.store import TripleStore

QUERIES = {
    **j_lubm.QUERIES,
    **t_lubm.OPERATOR_QUERIES,
    **j_lubm.J_QUERIES,
    **j_lubm.S_QUERIES,
}


def store_pair(scale: int = 1):
    js = j_lubm.generate(scale=scale, join_shapes=True, skew_shapes=True)
    terms = [js.dictionary.decode(i) for i in range(len(js.dictionary))]
    return js, TripleStore.from_arrays(js.triples, terms)


def engine_pair(stores, **kw):
    js, ts = stores
    return JEngine(js, **kw), TEngine(ts, device="cpu", **kw)


def run_both(engines, text: str):
    """One run on each engine: equal rows in order, equal join actuals."""
    je, te = engines
    a = je.prepare(text).run()
    b = te.prepare(text).run()
    assert b.rows == a.rows
    assert b.stats.join_totals == a.stats.join_totals
    assert b.stats.join_caps == a.stats.join_caps
    return a, b


def backend_module_tests(backend):
    """The row-equality tests of one join_backend setting, compiled and
    eager, cold then warm."""

    @pytest.fixture(scope="module")
    def engines():
        stores = store_pair()
        return {
            compiled: engine_pair(stores, join_backend=backend,
                                  compiled=compiled)
            for compiled in (True, False)
        }

    @pytest.mark.parametrize("compiled", [True, False])
    @pytest.mark.parametrize("name", list(QUERIES))
    def test_rows_equal_reference(engines, name, compiled):
        pair = engines[compiled]
        run_both(pair, QUERIES[name])
        _, warm = run_both(pair, QUERIES[name])
        if compiled:
            assert warm.stats.n_dispatches == 1
            assert warm.stats.n_compiles == 0
            assert warm.stats.cache_hits == 1

    return engines, test_rows_equal_reference


engines, test_rows_equal_reference = backend_module_tests(None)


@pytest.mark.parametrize("name", list(j_lubm.QUERIES) + ["S1"])
def test_rows_equal_reference_on_pallas_kernels(engines, name):
    j_compiled, te = engines[True]
    je = JEngine(j_compiled.store, use_kernel=True)
    run_both((je, te), QUERIES[name])
