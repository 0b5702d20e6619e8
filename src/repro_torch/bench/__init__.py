"""Benchmark harness (counterpart of ``repro.bench``): so far the two
functions the planner's measured policy calls; the scenarios, reports and
checks are ROADMAP Queue 1 item 7."""
