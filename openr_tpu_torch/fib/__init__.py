"""Fib: the route programming pipeline to the platform agent."""

from .fib import Fib, FibAgent, MockFibAgent, RouteState, longest_prefix_match

__all__ = ["Fib", "FibAgent", "MockFibAgent", "RouteState", "longest_prefix_match"]
