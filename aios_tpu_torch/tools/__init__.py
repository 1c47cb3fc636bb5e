"""aios.tools.ToolRegistry — capability-checked system tool execution.

Reference: tools/src/ (SURVEY.md section 2 rows 3, 3a-3i). Pipeline per
execution: validate -> capability check -> rate limit -> backup-if-reversible
-> execute -> audit (executor.rs:503-633).
"""
