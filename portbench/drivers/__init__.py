"""Window drivers, one per kind of mix (``traffic/<mix>.json``'s ``kind``):
``train`` drives the program's trainer, ``serve`` its serving engine."""
