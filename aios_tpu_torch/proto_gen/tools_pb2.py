# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tools.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0btools.proto\x12\naios.tools\"%\n\x10ListToolsRequest\x12\x11\n\tnamespace\x18\x01 \x01(\t\">\n\x11ListToolsResponse\x12)\n\x05tools\x18\x01 \x03(\x0b\x32\x1a.aios.tools.ToolDefinition\"\x1e\n\x0eGetToolRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\"\xa9\x02\n\x0eToolDefinition\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tnamespace\x18\x02 \x01(\t\x12\x0f\n\x07version\x18\x03 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x04 \x01(\t\x12\x14\n\x0cinput_schema\x18\x05 \x01(\x0c\x12\x15\n\routput_schema\x18\x06 \x01(\x0c\x12\x1d\n\x15required_capabilities\x18\x07 \x03(\t\x12\x12\n\nrisk_level\x18\x08 \x01(\t\x12\x1d\n\x15requires_confirmation\x18\t \x01(\x08\x12\x12\n\nidempotent\x18\n \x01(\x08\x12\x12\n\nreversible\x18\x0b \x01(\x08\x12\x12\n\ntimeout_ms\x18\x0c \x01(\x05\x12\x15\n\rrollback_tool\x18\r \x01(\t\"j\n\x0e\x45xecuteRequest\x12\x11\n\ttool_name\x18\x01 \x01(\t\x12\x10\n\x08\x61gent_id\x18\x02 \x01(\t\x12\x0f\n\x07task_id\x18\x03 \x01(\t\x12\x12\n\ninput_json\x18\x04 \x01(\x0c\x12\x0e\n\x06reason\x18\x05 \x01(\t\"\x84\x01\n\x0f\x45xecuteResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x13\n\x0boutput_json\x18\x02 \x01(\x0c\x12\r\n\x05\x65rror\x18\x03 \x01(\t\x12\x14\n\x0c\x65xecution_id\x18\x04 \x01(\t\x12\x13\n\x0b\x64uration_ms\x18\x05 \x01(\x03\x12\x11\n\tbackup_id\x18\x06 \x01(\t\"7\n\x0fRollbackRequest\x12\x14\n\x0c\x65xecution_id\x18\x01 \x01(\t\x12\x0e\n\x06reason\x18\x02 \x01(\t\"2\n\x10RollbackResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"X\n\x13RegisterToolRequest\x12(\n\x04tool\x18\x01 \x01(\x0b\x32\x1a.aios.tools.ToolDefinition\x12\x17\n\x0fhandler_address\x18\x02 \x01(\t\"7\n\x14RegisterToolResponse\x12\x10\n\x08\x61\x63\x63\x65pted\x18\x01 \x01(\x08\x12\r\n\x05\x65rror\x18\x02 \x01(\t\"*\n\x15\x44\x65registerToolRequest\x12\x11\n\ttool_name\x18\x01 \x01(\t\"*\n\x06Status\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t2\xba\x03\n\x0cToolRegistry\x12H\n\tListTools\x12\x1c.aios.tools.ListToolsRequest\x1a\x1d.aios.tools.ListToolsResponse\x12\x41\n\x07GetTool\x12\x1a.aios.tools.GetToolRequest\x1a\x1a.aios.tools.ToolDefinition\x12\x42\n\x07\x45xecute\x12\x1a.aios.tools.ExecuteRequest\x1a\x1b.aios.tools.ExecuteResponse\x12\x45\n\x08Rollback\x12\x1b.aios.tools.RollbackRequest\x1a\x1c.aios.tools.RollbackResponse\x12M\n\x08Register\x12\x1f.aios.tools.RegisterToolRequest\x1a .aios.tools.RegisterToolResponse\x12\x43\n\nDeregister\x12!.aios.tools.DeregisterToolRequest\x1a\x12.aios.tools.Statusb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tools_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _LISTTOOLSREQUEST._serialized_start=27
  _LISTTOOLSREQUEST._serialized_end=64
  _LISTTOOLSRESPONSE._serialized_start=66
  _LISTTOOLSRESPONSE._serialized_end=128
  _GETTOOLREQUEST._serialized_start=130
  _GETTOOLREQUEST._serialized_end=160
  _TOOLDEFINITION._serialized_start=163
  _TOOLDEFINITION._serialized_end=460
  _EXECUTEREQUEST._serialized_start=462
  _EXECUTEREQUEST._serialized_end=568
  _EXECUTERESPONSE._serialized_start=571
  _EXECUTERESPONSE._serialized_end=703
  _ROLLBACKREQUEST._serialized_start=705
  _ROLLBACKREQUEST._serialized_end=760
  _ROLLBACKRESPONSE._serialized_start=762
  _ROLLBACKRESPONSE._serialized_end=812
  _REGISTERTOOLREQUEST._serialized_start=814
  _REGISTERTOOLREQUEST._serialized_end=902
  _REGISTERTOOLRESPONSE._serialized_start=904
  _REGISTERTOOLRESPONSE._serialized_end=959
  _DEREGISTERTOOLREQUEST._serialized_start=961
  _DEREGISTERTOOLREQUEST._serialized_end=1003
  _STATUS._serialized_start=1005
  _STATUS._serialized_end=1047
  _TOOLREGISTRY._serialized_start=1050
  _TOOLREGISTRY._serialized_end=1492
# @@protoc_insertion_point(module_scope)
