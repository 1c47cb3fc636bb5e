"""aios.memory.MemoryService — three-tier memory (operational/working/long-term)
plus knowledge base, migration pipeline, and context assembly.

Reference: memory/src/ (SURVEY.md section 2 row 4).
"""
