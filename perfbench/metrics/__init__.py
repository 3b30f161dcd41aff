"""One reader a metric, found by the metric's name: ``read(run)`` returns the
metric's number from the run's record (harness.py), or None where the run
has nothing to read for it; a share of a roofline is never read as 0."""
