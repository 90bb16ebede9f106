"""The benchmark's traffic: the seeded phases of every cell.  Standard
library only; nothing of the program or of torch is loaded."""
