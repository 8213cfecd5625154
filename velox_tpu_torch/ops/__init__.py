"""Device primitives: group ids, sort keys, sorts and the grouped-sum
kernels."""
