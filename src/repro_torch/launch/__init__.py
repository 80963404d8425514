"""Drivers of the port (counterpart of ``repro/launch``): the training
loop (:mod:`.train`), the solo greedy-decode serving path (:mod:`.serve`)
and the step builders they share (:mod:`.steps`)."""
