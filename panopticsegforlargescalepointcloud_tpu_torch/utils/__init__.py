"""Host utilities: stage timers, the run log, neighbour-count diagnostics,
geometry helpers (rotations, axis-aligned boxes)."""
