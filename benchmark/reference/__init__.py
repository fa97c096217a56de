"""The plain reference of the benchmark: what ``picasso localize`` and
its RCC drift correction compute, written from their published
definitions in plain PyTorch and NumPy (the reference identification of
Picasso's ``localize.py``, the MLE fit of Smith et al., Nat. Methods 7,
373 (2010) as Picasso's ``gaussmle.py`` runs it, the RCC of Wang,
Schnitzbauer et al., Opt. Express 22, 15982 (2014) as Picasso's
``postprocess.undrift`` runs it). It imports nothing of the program and
takes nothing the program made: it works from the movie or the locs the
benchmark generated, in the precision it is given (float64 for the
reference, bfloat16 for the control)."""
