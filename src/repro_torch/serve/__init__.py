"""Serving data plane of the port: paged KV cache, engine, router, SLO tracker."""
