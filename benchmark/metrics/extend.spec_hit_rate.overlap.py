from benchmark.readers import spec_hit_rate as read  # noqa: F401
