"""The flagship decoder-only transformer and its solo decode."""
