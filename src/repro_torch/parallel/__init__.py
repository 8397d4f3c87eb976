"""Logical-axis sharding rules and the slot axis of the sharded KWS
engine (placing LM tensors on a mesh is ROADMAP.md queue 1 item 9c)."""
