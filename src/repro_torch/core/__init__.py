"""Relations, the MapReduce and matrix joins, the plan IR and the executor."""
