"""aios.api_gateway.ApiGateway — cloud + local inference routing.

Reference: api-gateway/src/ (SURVEY.md section 2 row 5). The `local`
provider differs by design: instead of llama-server HTTP on 127.0.0.1:8082 it
calls the TPU runtime's gRPC Infer — the always-available final fallback is
the TPU chip itself.
"""
