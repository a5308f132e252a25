"""Host utilities: stage timers, the run log, neighbour-count diagnostics."""
