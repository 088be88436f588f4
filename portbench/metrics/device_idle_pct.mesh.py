"""Rank 0's idle share of the traced window: ``device_idle_pct.batch``'s
reading of card 0 (the part of the window that no device operation on it
covers; a collective waiting for its peers counts as busy), in percent."""

from portbench.run import load_module

read = load_module("metrics", "device_idle_pct.batch").read
