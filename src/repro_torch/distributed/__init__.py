"""The training step of the port (one card; the mesh comes with ROADMAP
Queue 1 item 9)."""
