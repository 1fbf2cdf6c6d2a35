"""Device engine: resolved device, staged arrays, dispatch accounting,
and the runtime sanitizer of its dispatch paths."""

from .sanitizer import EngineSanitizer, SanitizerViolation

__all__ = ["EngineSanitizer", "SanitizerViolation"]
