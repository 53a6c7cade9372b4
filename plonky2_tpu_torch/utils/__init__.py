from . import bits
