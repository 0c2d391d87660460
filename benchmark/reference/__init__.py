"""The benchmark's plain reference: scene generator, front end, pose and
triangulation, ATE.  Plain NumPy and PyTorch; imports nothing of the
program under test."""
