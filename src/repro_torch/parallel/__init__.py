"""Distributed execution (counterpart of ``repro.parallel``): logical-axis
rules over a ``DeviceMesh`` (``axes``), parameter and cache placements
(``sharding``), the partitioned MEC conv (``conv``), the int8-compressed
gradient reduction (``compression``), GPipe (``pipeline``) and the
collectives they share (``comm``)."""
