"""Runtime: failure detection, stragglers, restart policy."""
