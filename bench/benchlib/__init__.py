"""The benchmark's own library: the registry of cells, metrics and
references, the inputs made from a seed, the device's peaks, the profiler
reading, and the comparison that decides ``correct``.  Nothing here imports
the program; :mod:`benchlib.driver` reaches it through ``bench/families``.
"""
