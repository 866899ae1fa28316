"""The benchmark's harness: the spec, the traffic generator, the runners
of each traffic kind, the yardstick's arithmetic and the checks."""
