"""The program's entries that traffic drives, one module an entry (see
harness.py for what a module provides)."""
