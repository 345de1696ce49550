"""Measurement scripts of the port that run on the card
(``python -m taming_event_flow_tpu_torch.tools.<name>``)."""
