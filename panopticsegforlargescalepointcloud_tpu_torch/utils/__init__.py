"""Host utilities: spans and counters (`trace`), the run log, neighbour-count diagnostics,
geometry helpers (rotations, axis-aligned boxes)."""
