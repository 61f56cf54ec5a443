"""Serving: the continuous-batching engine over the port's serve steps."""
