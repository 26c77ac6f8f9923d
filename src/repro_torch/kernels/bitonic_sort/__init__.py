"""Sort of int32 (key, payload) pairs: sort_pairs and argsort_i32."""
