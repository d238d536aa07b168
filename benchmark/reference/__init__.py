"""The plain reference that decides a run's ``correct``.

Plain NumPy and plain PyTorch only: it imports nothing of the program
under test, and takes nothing that the program made.  It works out the
Chebyshev grid, the node values of the configuration's function, the
barycentric rows and the spectral derivatives itself, and evaluates the
interpolant in float64 (the reference) or in TF32 (the control, the
precision below the float32 that the cells state).
"""
