"""Multi-tenant QoS: the tenant-policy model (``policy.py``)."""
