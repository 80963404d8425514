"""Serving drivers of the port (counterpart of ``repro/launch``): the solo
greedy-decode path (:mod:`.steps`, :mod:`.serve`)."""
