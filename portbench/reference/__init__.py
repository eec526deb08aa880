"""The plain reference: NumPy and SciPy in float64 (and PyTorch for the
lower-precision control), written from the model's definition.  It
imports nothing of ``bayesfmmm_torch`` and takes nothing the program made:
it builds its own basis from the raw time points and reads the program's
returned states only to judge them."""
