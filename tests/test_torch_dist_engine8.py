"""ShardedQueryEngine with one shard per process at LUBM scale 1 over 8
ranks (gloo on the CPU): the checks of test_torch_dist_engine.py."""
import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import torch  # noqa: F401

from test_torch_dist_engine import engine_module_tests

(world, test_rank0_arrays_and_stats_equal_one_process,
 test_every_rank_makes_the_same_calls,
 test_each_rank_stages_its_own_shard,
 test_forced_retry_and_memory_error_on_every_rank,
 test_run_batch_update_and_the_query_after,
 test_rank0_rows_equal_the_oracle) = engine_module_tests(
    {"8": ((8,), ("shards",))},
    scale=1, oracle=("Q1", "Q4", "F1", "J1", "J2", "S1"),
)
