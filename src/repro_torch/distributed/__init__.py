"""Host-side helpers of the failure model."""
