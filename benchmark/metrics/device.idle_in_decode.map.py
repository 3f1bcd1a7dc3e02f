from benchmark.spans import idle_in_decode as read  # noqa: F401
