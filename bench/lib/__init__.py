"""Arithmetic and plumbing shared by every cell: statistics, operation and
byte counts, the profiler's reading, seeded weights and traffic, the result."""
