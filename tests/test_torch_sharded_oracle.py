"""The port's ShardedQueryEngine (device="cpu") against the NumPy oracle
(the reference's `sparql/baseline.reference_rows`) on every LUBM query, at
1, 2, 4 and 8 shards and on a 2 x 2 mesh, as multisets."""
import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import pytest
import torch  # noqa: F401

from repro.sparql.baseline import reference_rows
from repro.sparql.parser import parse as j_parse

from test_torch_engine_default import QUERIES, store_pair
from test_torch_sharded_engine import CONFIGS, rows_key, sharded_engine


@pytest.fixture(scope="module")
def lubm():
    """The reference's store and one sharded engine per configuration."""
    js, ts = store_pair()
    return js, {c: sharded_engine(ts, c) for c in CONFIGS}


@pytest.mark.parametrize("name", list(QUERIES))
def test_lubm_rows_equal_oracle(lubm, name):
    js, engines = lubm
    text = QUERIES[name]
    want = rows_key(reference_rows(js, j_parse(text)))
    for config, eng in engines.items():
        got = rows_key(eng.query(text))
        if "LIMIT" in text:  # any right-sized subset is a correct slice
            assert set(got) <= set(want), config
            assert len(got) == min(len(want), int(text.split("LIMIT")[1]))
        else:
            assert got == want, config
