"""Matrix generators, one module a name (``gen/<name>.py``).

Each module defines ``coo(n, rng, params, made)``: the lower triangle,
diagonal included, of a symmetric matrix as ``(rows, cols, vals)`` numpy
arrays, drawn from the ``numpy.random.Generator`` ``rng``.  ``params`` is
the matrix's entry of its configuration file; ``made`` holds the
matrices the configuration made before this one, by role, as
``(rows, cols, vals)``.
"""
