"""The entry modules that drive the program, one a family of traffic: a
mix's ``entry`` names its module. Each defines ``Runner(cfg, mix, seed,
device, trace, split)`` with ``window(seconds)``, ``end_to_end(result)``,
``release()`` and ``judge(result)``."""
