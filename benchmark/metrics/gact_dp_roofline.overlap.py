from benchmark.readers import gact_dp_roofline as read  # noqa: F401
