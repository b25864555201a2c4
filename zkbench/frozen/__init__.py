"""Copies of the port's measurement helpers, frozen so that a later change to
the port cannot move the yardstick. Each file names the file it was copied
from and the commit (88d1ffc) it was copied at; the harness imports these
copies and never the originals."""
