# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: api_gateway.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import common_pb2 as common__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x11\x61pi_gateway.proto\x12\x10\x61ios.api_gateway\x1a\x0c\x63ommon.proto\"\xd5\x01\n\x0f\x41piInferRequest\x12\x0e\n\x06prompt\x18\x01 \x01(\t\x12\x15\n\rsystem_prompt\x18\x02 \x01(\t\x12\x12\n\nmax_tokens\x18\x03 \x01(\x05\x12\x13\n\x0btemperature\x18\x04 \x01(\x02\x12\x1a\n\x12preferred_provider\x18\x05 \x01(\t\x12\x18\n\x10requesting_agent\x18\x06 \x01(\t\x12\x0f\n\x07task_id\x18\x07 \x01(\t\x12\x16\n\x0e\x61llow_fallback\x18\x08 \x01(\x08\x12\x13\n\x0bjson_schema\x18\t \x01(\t\";\n\x0bStreamChunk\x12\x0c\n\x04text\x18\x01 \x01(\t\x12\x0c\n\x04\x64one\x18\x02 \x01(\x08\x12\x10\n\x08provider\x18\x03 \x01(\t\"\xcf\x01\n\x0c\x42udgetStatus\x12!\n\x19\x63laude_monthly_budget_usd\x18\x01 \x01(\x01\x12\x17\n\x0f\x63laude_used_usd\x18\x02 \x01(\x01\x12!\n\x19openai_monthly_budget_usd\x18\x03 \x01(\x01\x12\x17\n\x0fopenai_used_usd\x18\x04 \x01(\x01\x12\x16\n\x0e\x64\x61ys_remaining\x18\x05 \x01(\x05\x12\x16\n\x0e\x64\x61ily_rate_usd\x18\x06 \x01(\x01\x12\x17\n\x0f\x62udget_exceeded\x18\x07 \x01(\x08\".\n\x0cUsageRequest\x12\x10\n\x08provider\x18\x01 \x01(\t\x12\x0c\n\x04\x64\x61ys\x18\x02 \x01(\x05\"\x85\x01\n\rUsageResponse\x12.\n\x07records\x18\x01 \x03(\x0b\x32\x1d.aios.api_gateway.UsageRecord\x12\x16\n\x0etotal_cost_usd\x18\x02 \x01(\x01\x12\x16\n\x0etotal_requests\x18\x03 \x01(\x05\x12\x14\n\x0ctotal_tokens\x18\x04 \x01(\x05\"\xab\x01\n\x0bUsageRecord\x12\x10\n\x08provider\x18\x01 \x01(\t\x12\r\n\x05model\x18\x02 \x01(\t\x12\x14\n\x0cinput_tokens\x18\x03 \x01(\x05\x12\x15\n\routput_tokens\x18\x04 \x01(\x05\x12\x10\n\x08\x63ost_usd\x18\x05 \x01(\x01\x12\x11\n\ttimestamp\x18\x06 \x01(\x03\x12\x18\n\x10requesting_agent\x18\x07 \x01(\t\x12\x0f\n\x07task_id\x18\x08 \x01(\t2\xb9\x02\n\nApiGateway\x12J\n\x05Infer\x12!.aios.api_gateway.ApiInferRequest\x1a\x1e.aios.common.InferenceResponse\x12Q\n\x0bStreamInfer\x12!.aios.api_gateway.ApiInferRequest\x1a\x1d.aios.api_gateway.StreamChunk0\x01\x12?\n\tGetBudget\x12\x12.aios.common.Empty\x1a\x1e.aios.api_gateway.BudgetStatus\x12K\n\x08GetUsage\x12\x1e.aios.api_gateway.UsageRequest\x1a\x1f.aios.api_gateway.UsageResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'api_gateway_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _APIINFERREQUEST._serialized_start=54
  _APIINFERREQUEST._serialized_end=267
  _STREAMCHUNK._serialized_start=269
  _STREAMCHUNK._serialized_end=328
  _BUDGETSTATUS._serialized_start=331
  _BUDGETSTATUS._serialized_end=538
  _USAGEREQUEST._serialized_start=540
  _USAGEREQUEST._serialized_end=586
  _USAGERESPONSE._serialized_start=589
  _USAGERESPONSE._serialized_end=722
  _USAGERECORD._serialized_start=725
  _USAGERECORD._serialized_end=896
  _APIGATEWAY._serialized_start=899
  _APIGATEWAY._serialized_end=1212
# @@protoc_insertion_point(module_scope)
