from .parser import DEFAULTS, YAMLParser, deep_merge

__all__ = ["DEFAULTS", "YAMLParser", "deep_merge"]
