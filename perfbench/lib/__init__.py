"""The benchmark's yardstick: traffic generation, the NVML energy read,
the profiler's reduction, the operation and byte counts, the H100's
peaks, and the comparison that decides ``correct``.  Nothing here
imports the program under test except ``bench``, which drives it."""
