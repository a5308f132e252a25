"""Tools run by hand to set the benchmark's limits: the precision control
and the planted faults (:mod:`.faults`), read over many seeds on the chip
(:mod:`.calibrate`). The benchmark's own runs do not run them."""
