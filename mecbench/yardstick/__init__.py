"""The benchmark's yardstick: the card's peaks and the operations and
bytes of the work the cells run, counted alike whatever implements it."""
