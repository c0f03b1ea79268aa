"""One module a simulator of the port, named as a configuration's "sim"
names it: its draws, the program it drives (the port, or the reference in
the program's place), what a step keeps for the comparison, and the
comparison with the reference."""
