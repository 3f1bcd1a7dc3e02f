from benchmark.readers import index_build_s as read  # noqa: F401
