"""Tests of the port's benchmark: CPU tests at small widths, and the card
tests (marked ``cuda``) that skip without a card."""
