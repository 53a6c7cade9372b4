from . import extension, goldilocks
