# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: common.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0c\x63ommon.proto\x12\x0b\x61ios.common\"\x07\n\x05\x45mpty\"*\n\x06Status\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\"\x15\n\x07\x41gentId\x12\n\n\x02id\x18\x01 \x01(\t\"\x14\n\x06GoalId\x12\n\n\x02id\x18\x01 \x01(\t\"\xa6\x01\n\x04Goal\x12\n\n\x02id\x18\x01 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x02 \x01(\t\x12\x10\n\x08priority\x18\x03 \x01(\x05\x12\x0e\n\x06source\x18\x04 \x01(\t\x12\x0e\n\x06status\x18\x05 \x01(\t\x12\x12\n\ncreated_at\x18\x06 \x01(\x03\x12\x12\n\nupdated_at\x18\x07 \x01(\x03\x12\x0c\n\x04tags\x18\x08 \x03(\t\x12\x15\n\rmetadata_json\x18\t \x01(\x0c\"\x9e\x02\n\x04Task\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0f\n\x07goal_id\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x65scription\x18\x03 \x01(\t\x12\x16\n\x0e\x61ssigned_agent\x18\x04 \x01(\t\x12\x0e\n\x06status\x18\x05 \x01(\t\x12\x1a\n\x12intelligence_level\x18\x06 \x01(\t\x12\x16\n\x0erequired_tools\x18\x07 \x03(\t\x12\x12\n\ndepends_on\x18\x08 \x03(\t\x12\x12\n\ninput_json\x18\t \x01(\x0c\x12\x13\n\x0boutput_json\x18\n \x01(\x0c\x12\x12\n\ncreated_at\x18\x0b \x01(\x03\x12\x12\n\nstarted_at\x18\x0c \x01(\x03\x12\x14\n\x0c\x63ompleted_at\x18\r \x01(\x03\x12\r\n\x05\x65rror\x18\x0e \x01(\t\"\x90\x01\n\nTaskResult\x12\x0f\n\x07task_id\x18\x01 \x01(\t\x12\x0f\n\x07success\x18\x02 \x01(\x08\x12\x13\n\x0boutput_json\x18\x03 \x01(\x0c\x12\r\n\x05\x65rror\x18\x04 \x01(\t\x12\x13\n\x0b\x64uration_ms\x18\x05 \x01(\x03\x12\x13\n\x0btokens_used\x18\x06 \x01(\x05\x12\x12\n\nmodel_used\x18\x07 \x01(\t\"\x8f\x01\n\x11\x41gentRegistration\x12\x10\n\x08\x61gent_id\x18\x01 \x01(\t\x12\x12\n\nagent_type\x18\x02 \x01(\t\x12\x14\n\x0c\x63\x61pabilities\x18\x03 \x03(\t\x12\x17\n\x0ftool_namespaces\x18\x04 \x03(\t\x12\x0e\n\x06status\x18\x05 \x01(\t\x12\x15\n\rregistered_at\x18\x06 \x01(\x03\"\xb8\x01\n\x10InferenceRequest\x12\x0e\n\x06prompt\x18\x01 \x01(\t\x12\x15\n\rsystem_prompt\x18\x02 \x01(\t\x12\x12\n\nmax_tokens\x18\x03 \x01(\x05\x12\x13\n\x0btemperature\x18\x04 \x01(\x02\x12\x1a\n\x12intelligence_level\x18\x05 \x01(\t\x12\r\n\x05model\x18\x06 \x01(\t\x12\x18\n\x10requesting_agent\x18\x07 \x01(\t\x12\x0f\n\x07task_id\x18\x08 \x01(\t\"z\n\x11InferenceResponse\x12\x0c\n\x04text\x18\x01 \x01(\t\x12\x13\n\x0btokens_used\x18\x02 \x01(\x05\x12\x12\n\nlatency_ms\x18\x03 \x01(\x03\x12\x12\n\nmodel_used\x18\x04 \x01(\t\x12\x1a\n\x12intelligence_level\x18\x05 \x01(\t\"{\n\x13ServiceRegistration\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07\x61\x64\x64ress\x18\x02 \x01(\t\x12\x0c\n\x04port\x18\x03 \x01(\x05\x12\x10\n\x08protocol\x18\x04 \x01(\t\x12\x0e\n\x06status\x18\x05 \x01(\t\x12\x15\n\rregistered_at\x18\x06 \x01(\x03\"\xc2\x01\n\x0cHealthStatus\x12\x0f\n\x07healthy\x18\x01 \x01(\x08\x12\x0f\n\x07service\x18\x02 \x01(\t\x12\x0f\n\x07message\x18\x03 \x01(\t\x12\x16\n\x0euptime_seconds\x18\x04 \x01(\x03\x12\x37\n\x07\x64\x65tails\x18\x05 \x03(\x0b\x32&.aios.common.HealthStatus.DetailsEntry\x1a.\n\x0c\x44\x65tailsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01*\x80\x01\n\nGoalStatus\x12\x10\n\x0cGOAL_PENDING\x10\x00\x12\x11\n\rGOAL_PLANNING\x10\x01\x12\x14\n\x10GOAL_IN_PROGRESS\x10\x02\x12\x12\n\x0eGOAL_COMPLETED\x10\x03\x12\x0f\n\x0bGOAL_FAILED\x10\x04\x12\x12\n\x0eGOAL_CANCELLED\x10\x05*\x80\x01\n\nTaskStatus\x12\x10\n\x0cTASK_PENDING\x10\x00\x12\x11\n\rTASK_ASSIGNED\x10\x01\x12\x14\n\x10TASK_IN_PROGRESS\x10\x02\x12\x12\n\x0eTASK_COMPLETED\x10\x03\x12\x0f\n\x0bTASK_FAILED\x10\x04\x12\x12\n\x0eTASK_CANCELLED\x10\x05\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'common_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _HEALTHSTATUS_DETAILSENTRY._options = None
  _HEALTHSTATUS_DETAILSENTRY._serialized_options = b'8\001'
  _GOALSTATUS._serialized_start=1512
  _GOALSTATUS._serialized_end=1640
  _TASKSTATUS._serialized_start=1643
  _TASKSTATUS._serialized_end=1771
  _EMPTY._serialized_start=29
  _EMPTY._serialized_end=36
  _STATUS._serialized_start=38
  _STATUS._serialized_end=80
  _AGENTID._serialized_start=82
  _AGENTID._serialized_end=103
  _GOALID._serialized_start=105
  _GOALID._serialized_end=125
  _GOAL._serialized_start=128
  _GOAL._serialized_end=294
  _TASK._serialized_start=297
  _TASK._serialized_end=583
  _TASKRESULT._serialized_start=586
  _TASKRESULT._serialized_end=730
  _AGENTREGISTRATION._serialized_start=733
  _AGENTREGISTRATION._serialized_end=876
  _INFERENCEREQUEST._serialized_start=879
  _INFERENCEREQUEST._serialized_end=1063
  _INFERENCERESPONSE._serialized_start=1065
  _INFERENCERESPONSE._serialized_end=1187
  _SERVICEREGISTRATION._serialized_start=1189
  _SERVICEREGISTRATION._serialized_end=1312
  _HEALTHSTATUS._serialized_start=1315
  _HEALTHSTATUS._serialized_end=1509
  _HEALTHSTATUS_DETAILSENTRY._serialized_start=1463
  _HEALTHSTATUS_DETAILSENTRY._serialized_end=1509
# @@protoc_insertion_point(module_scope)
