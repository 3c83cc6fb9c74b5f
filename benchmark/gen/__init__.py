"""Seeded inputs of a cell: the probe DB (db.py) and the pool of read or
contig files (samples.py), made from ``--seed`` alone.  Both sides get the
same inputs: the program the files and the DB, the reference the arrays
they were written from."""
