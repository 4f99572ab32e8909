"""The plain reference of a scan's recommendations (NumPy and ``decimal``
only; it imports nothing of the program)."""
