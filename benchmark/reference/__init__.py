"""The plain reference of the classifiers' outputs: ``scalar.py`` is the
read-by-read model of the C++ reference in the standard library alone
(process_qual, process_read, the counters and the saved reads),
``vector.py`` computes the same outputs over whole samples in plain
PyTorch and NumPy.  Neither imports any package of the repository; they
take the generator's keys, targets, tree and records, never the program's
packed DB or tables."""
