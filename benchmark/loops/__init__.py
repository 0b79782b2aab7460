"""How a cell's requests reach the port: one module per ``loop`` named in a
traffic mix. Each defines ``Loop(device, ranges)``, whose ``serve(datas,
rec)`` decodes one request's JPEGs and returns their planes (synchronised
with the device), and which records its spans and counters in ``rec``
(:class:`benchmark.records.Records`). ``ranges`` puts each call into the
port inside a ``bench.*`` profiler range."""
