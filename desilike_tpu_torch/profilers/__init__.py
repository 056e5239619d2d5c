from .base import BaseProfiler, ScipyProfiler, OptaxProfiler
