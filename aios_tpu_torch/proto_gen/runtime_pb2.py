# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: runtime.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import common_pb2 as common__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rruntime.proto\x12\x0c\x61ios.runtime\x1a\x0c\x63ommon.proto\"\x85\x01\n\x10LoadModelRequest\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12\x12\n\nmodel_path\x18\x02 \x01(\t\x12\x16\n\x0e\x63ontext_length\x18\x03 \x01(\x05\x12\x12\n\ngpu_layers\x18\x04 \x01(\x05\x12\x0f\n\x07threads\x18\x05 \x01(\x05\x12\x0c\n\x04port\x18\x06 \x01(\x05\"(\n\x12UnloadModelRequest\x12\x12\n\nmodel_name\x18\x01 \x01(\t\"|\n\x0bModelStatus\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12\x0e\n\x06status\x18\x02 \x01(\t\x12\x0c\n\x04port\x18\x03 \x01(\x05\x12\x11\n\tloaded_at\x18\x04 \x01(\x03\x12\x11\n\tlast_used\x18\x05 \x01(\x03\x12\x15\n\rrequest_count\x18\x06 \x01(\x03\"6\n\tModelList\x12)\n\x06models\x18\x01 \x03(\x0b\x32\x19.aios.runtime.ModelStatus\"\xc9\x01\n\x0cInferRequest\x12\r\n\x05model\x18\x01 \x01(\t\x12\x0e\n\x06prompt\x18\x02 \x01(\t\x12\x15\n\rsystem_prompt\x18\x03 \x01(\t\x12\x12\n\nmax_tokens\x18\x04 \x01(\x05\x12\x13\n\x0btemperature\x18\x05 \x01(\x02\x12\x1a\n\x12intelligence_level\x18\x06 \x01(\t\x12\x18\n\x10requesting_agent\x18\x07 \x01(\t\x12\x0f\n\x07task_id\x18\x08 \x01(\t\x12\x13\n\x0bjson_schema\x18\t \x01(\t\"Z\n\rInferResponse\x12\x0c\n\x04text\x18\x01 \x01(\t\x12\x13\n\x0btokens_used\x18\x02 \x01(\x05\x12\x12\n\nlatency_ms\x18\x03 \x01(\x03\x12\x12\n\nmodel_used\x18\x04 \x01(\t\"(\n\nInferChunk\x12\x0c\n\x04text\x18\x01 \x01(\t\x12\x0c\n\x04\x64one\x18\x02 \x01(\x08\x32\x9b\x03\n\tAIRuntime\x12\x46\n\tLoadModel\x12\x1e.aios.runtime.LoadModelRequest\x1a\x19.aios.runtime.ModelStatus\x12\x44\n\x0bUnloadModel\x12 .aios.runtime.UnloadModelRequest\x1a\x13.aios.common.Status\x12\x39\n\nListModels\x12\x12.aios.common.Empty\x1a\x17.aios.runtime.ModelList\x12@\n\x05Infer\x12\x1a.aios.runtime.InferRequest\x1a\x1b.aios.runtime.InferResponse\x12\x45\n\x0bStreamInfer\x12\x1a.aios.runtime.InferRequest\x1a\x18.aios.runtime.InferChunk0\x01\x12<\n\x0bHealthCheck\x12\x12.aios.common.Empty\x1a\x19.aios.common.HealthStatusb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'runtime_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _LOADMODELREQUEST._serialized_start=46
  _LOADMODELREQUEST._serialized_end=179
  _UNLOADMODELREQUEST._serialized_start=181
  _UNLOADMODELREQUEST._serialized_end=221
  _MODELSTATUS._serialized_start=223
  _MODELSTATUS._serialized_end=347
  _MODELLIST._serialized_start=349
  _MODELLIST._serialized_end=403
  _INFERREQUEST._serialized_start=406
  _INFERREQUEST._serialized_end=607
  _INFERRESPONSE._serialized_start=609
  _INFERRESPONSE._serialized_end=699
  _INFERCHUNK._serialized_start=701
  _INFERCHUNK._serialized_end=741
  _AIRUNTIME._serialized_start=744
  _AIRUNTIME._serialized_end=1155
# @@protoc_insertion_point(module_scope)
