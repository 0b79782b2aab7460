"""Megapixels per second served, read as ``end_to_end/mps.py`` reads them
(every image of the window over its seconds, on the host clock), in a cell
whose host's speed spreads them past any bound end to end."""

from benchmark.records import load_reader

read = load_reader("end_to_end", "mps")
