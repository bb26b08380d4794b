"""Work counted from shapes: the card's peaks, K2's operations and bytes,
and the models' multiply-accumulates.  The benchmark's own counts, so a
change to the program cannot move the yardstick."""
